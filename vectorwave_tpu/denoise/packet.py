"""Best-basis wavelet packet denoising.

Beyond-reference composition: pick a Coifman–Wickerhauser basis of an
undecimated packet tree, shrink each basis node with the standard threshold
selectors (universal / SURE / minimax / BayesShrink), reconstruct.  Against
the plain MODWT denoiser this adapts the frequency tiling to the signal —
narrowband structure in a HIGH band gets its own node instead of sharing a
whole detail level with the noise (on a two-tone test with one tone at 0.41
cycles/sample, packet denoising roughly halves the MODWT denoiser's MSE).

Noise model: per-stage 1/sqrt(2) filter scaling makes white noise of std
``sigma`` contribute ``sigma / sqrt(2^j)`` to every depth-``j`` packet node.
``sigma`` itself is estimated as the NOISE FLOOR across the deepest-level
nodes — the median of per-node MADs rescaled by ``sqrt(2^J)`` — which stays
honest when narrowband signal occupies some bands (a single-band MAD, the
MODWT denoiser's estimator, overestimates sigma ~2x there).  The DC-path
node ``(j, 0)`` passes through untouched (the approximation, as in the
MODWT denoiser).

Execution shape: everything is ONE jitted device program — the
Coifman–Wickerhauser DP runs on device over the tiny per-level cost vectors
and the chosen basis becomes per-level USED masks feeding a masked bottom-up
synthesis (transforms/packets2d._device_best_basis_masks).  No host sync and
no per-basis recompiles: an eager composition pays one dispatch per op, and
a host-side DP recompiles the reconstruction whenever the data changes the
basis.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..ops.thresholds import apply_threshold, mad_sigma, select_threshold
from ..transforms.packets import best_basis, modwpt, reconstruct_basis
from ..transforms.packets2d import (
    _EPS,
    _node_costs,
    best_basis2,
    reconstruct_basis2,
    wpt2,
)

__all__ = ["denoise_packet", "denoise_packet2"]

from .._jitcache import BoundedCache

# bounded: long-lived serving processes feeding many distinct shapes must
# not leak one compiled program per shape
_jit_cache: BoundedCache = BoundedCache(128)


def _noise_floor_sigma(tree) -> jnp.ndarray:
    """Median of depth-rescaled per-node MADs at the deepest level,
    ``[..., 1]`` (broadcastable against node coefficients)."""
    depth = tree.depth
    mads = mad_sigma(tree.levels[depth])[..., 0]  # [..., 2^J]
    return jnp.median(mads, axis=-1, keepdims=True) * math.sqrt(2.0**depth)


def denoise_packet(
    x: jnp.ndarray,
    wavelet,
    levels: int = 4,
    *,
    cost: str = "threshold",
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Denoise via best-basis packet thresholding.

    ``cost`` picks the basis-selection criterion; the default "threshold"
    counts coefficients above the deepest level's noise-scaled universal
    threshold (a sparsity-relative-to-noise measure — the entropy costs
    tend to keep the root on noisy inputs, which would make the denoiser a
    no-op).  The whole pipeline — analysis, on-device basis DP, masked
    shrinkage and synthesis — is ONE jitted device program.
    """
    import jax

    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    if callable(cost):  # legacy callable costs: eager path
        tree = modwpt(x, w, levels, boundary=boundary)
        sigma = _noise_floor_sigma(tree)
        basis = best_basis(tree, cost=cost)
        return _reconstruct_shrunk_1d(tree, basis, w, sigma, method, mode,
                                      boundary)
    from ..transforms.packets import _imodwpt_pair
    from ..transforms.packets2d import _device_best_basis_masks

    key = ("pk1", w.name, levels, cost, boundary, method, mode, x.shape,
           str(x.dtype))
    run = _jit_cache.get(key)
    if run is None:
        def _run(z):
            tree = modwpt(z, w, levels, boundary=boundary)
            sigma = _noise_floor_sigma(tree)
            thr = (
                jnp.mean(sigma)
                * jnp.sqrt(2.0 * jnp.log(float(z.shape[-1])))
                / jnp.sqrt(2.0**levels)
            )
            root_energy = jnp.sum(tree.levels[0] ** 2) + _EPS
            costs = [
                _node_costs(lvl, cost, thr, root_energy, axes=(-1,)).sum(
                    axis=tuple(range(lvl.ndim - 2))
                )
                for lvl in tree.levels
            ]
            used = _device_best_basis_masks(costs, levels, 2)

            def shrunk(j):
                lvl = tree.levels[j]  # [..., 2^j, N]
                level_sigma = sigma[..., None] / jnp.sqrt(2.0**j)
                threshold = select_threshold(lvl, level_sigma, method)
                s = apply_threshold(lvl, threshold, mode)
                # DC path (node 0 of any level): pure approximation,
                # passes through untouched
                idx = jnp.arange(1 << j)[:, None]
                s = jnp.where(idx == 0, lvl, s)
                return s * used[j].astype(z.dtype)[:, None]

            val = shrunk(levels)
            for j in range(levels, 0, -1):
                val = _imodwpt_pair(val, w, 1 << (j - 1), boundary)
                val = val + shrunk(j - 1)
            return val[..., 0, :]

        run = _jit_cache[key] = jax.jit(_run)
    return run(x)


def _reconstruct_shrunk_1d(tree, basis, w, sigma, method, mode, boundary):
    def shrink(level: int, idx: int, coeffs: jnp.ndarray) -> jnp.ndarray:
        if idx == 0:  # DC path: pure approximation, pass through
            return coeffs
        level_sigma = sigma / jnp.sqrt(2.0**level)
        threshold = select_threshold(coeffs, level_sigma, method)
        return apply_threshold(coeffs, threshold, mode)

    return reconstruct_basis(
        tree, basis, w, boundary=boundary, transform_nodes=shrink
    )


def denoise_packet2(
    x: jnp.ndarray,
    wavelet,
    levels: int = 3,
    *,
    cost: str = "risk",
    method: str = "universal",
    mode: str = "hard",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """2-D best-basis packet denoising over the decimated quadtree.

    Default shrinkage is HARD: the basis concentrates texture into few
    large coefficients, and soft's constant-``t`` bias shaves exactly those
    (on the oscillatory-weave test hard roughly halves soft's MSE).

    The default basis cost is the Donoho-Johnstone threshold-risk proxy
    ``sum min(c^2, t^2)`` — the count-above-threshold cost is DEGENERATE for
    decimated denoising: a weak-per-sample texture spread below ``t`` at the
    root counts near zero, so the DP would "optimally" hide the signal in
    the noise and the denoiser would pass it through untouched.  The risk
    cost charges each surviving coefficient only ``t^2``, so concentrating
    the texture into a few large packet coefficients wins.

    The quadtree is ORTHONORMAL for orthogonal wavelets, so white noise of
    std ``sigma`` keeps std ``sigma`` in every node at every depth — no
    level rescaling.  ``sigma`` is the noise floor across the deepest-level
    nodes (median of per-node MADs), robust when texture occupies some
    bands; the universal threshold uses ``N = H*W`` (2-D VisuShrink).  The
    DC-path node ``(j, 0)`` passes through.  Decimated thresholding is not
    shift-invariant — use :func:`..transforms.twodim.denoise2` (MODWT-based)
    when shift invariance matters more than the adaptive tiling.
    """
    import jax

    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    n_total = x.shape[-1] * x.shape[-2]
    if callable(cost):  # legacy callable costs: eager path
        tree = wpt2(x, w, levels, boundary=boundary)
        leaves = tree.leaves
        flat = leaves.reshape(leaves.shape[:-2] + (-1,))
        sigma = jnp.median(mad_sigma(flat)[..., 0], axis=-1, keepdims=True)
        basis = best_basis2(tree, cost=cost)
        return _reconstruct_shrunk_2d(tree, basis, w, sigma, n_total, method,
                                      mode, boundary)
    from ..transforms.packets2d import (
        _device_best_basis_masks,
        _iwpt2_quad,
    )

    key = ("pk2", w.name, levels, cost, boundary, method, mode, x.shape,
           str(x.dtype))
    run = _jit_cache.get(key)
    if run is None:
        def _run(z):
            tree = wpt2(z, w, levels, boundary=boundary)
            leaves = tree.leaves
            flat = leaves.reshape(leaves.shape[:-2] + (-1,))
            sigma = jnp.median(
                mad_sigma(flat)[..., 0], axis=-1, keepdims=True
            )
            thr = jnp.mean(sigma) * jnp.sqrt(2.0 * jnp.log(float(n_total)))
            root_energy = jnp.sum(tree.levels[0] ** 2) + _EPS
            costs = [
                _node_costs(lvl, cost, thr, root_energy).sum(
                    axis=tuple(range(lvl.ndim - 3))
                )
                for lvl in tree.levels
            ]
            used = _device_best_basis_masks(costs, levels, 4)

            def shrunk(j):
                lvl = tree.levels[j]  # [..., 4^j, h, w]
                vec = lvl.reshape(lvl.shape[:-2] + (-1,))
                if method.lower() == "universal":
                    threshold = (
                        sigma * math.sqrt(2.0 * math.log(n_total))
                    )[..., None]
                else:
                    threshold = select_threshold(vec, sigma[..., None],
                                                 method)
                s = apply_threshold(vec, threshold, mode).reshape(lvl.shape)
                # DC path (node 0 of any level) passes through
                idx = jnp.arange(1 << (2 * j))[:, None, None]
                s = jnp.where(idx == 0, lvl, s)
                return s * used[j].astype(z.dtype)[:, None, None]

            val = shrunk(levels)
            for j in range(levels, 0, -1):
                val = _iwpt2_quad(val, w, boundary)
                val = val + shrunk(j - 1)
            return val[..., 0, :, :]

        run = _jit_cache[key] = jax.jit(_run)
    return run(x)


def _reconstruct_shrunk_2d(tree, basis, w, sigma, n_total, method, mode,
                           boundary):
    def shrink(level: int, idx: int, plane: jnp.ndarray) -> jnp.ndarray:
        if idx == 0:  # DC path: pure approximation, pass through
            return plane
        vec = plane.reshape(plane.shape[:-2] + (-1,))
        if method.lower() == "universal":
            threshold = sigma * math.sqrt(2.0 * math.log(n_total))
        else:
            threshold = select_threshold(vec, sigma, method)
        return apply_threshold(vec, threshold, mode).reshape(plane.shape)

    return reconstruct_basis2(
        tree, basis, w, boundary=boundary, transform_nodes=shrink
    )
