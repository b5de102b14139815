"""Wavelet packet transforms — decimated WPT and undecimated MODWPT.

Beyond-reference capability (MorphIQ-Labs/VectorWave has no packet
transforms; grep for "packet" over ``/root/reference`` is empty): the full
binary filter-bank tree over both the approximation AND detail branches,
with Coifman–Wickerhauser best-basis selection and frequency (sequency)
ordering of the leaves.

Design notes:

* A packet level is ONE batched op: the node axis is just another leading
  batch axis, so depth ``j`` costs two à trous (or decimated) convolutions
  over a ``[..., 2^(j-1), N]`` array — XLA sees large fused elementwise
  sums, never a Python loop over nodes.
* The tree is a NamedTuple of per-depth arrays (a pytree — jittable,
  shardable along batch axes, orbax-checkpointable like every other carry
  in this package).
* Best-basis selection is data-dependent (it compares node costs), so it
  runs host-side on a cost table pulled from the device in one transfer;
  reconstruction from a chosen basis is again a pure jittable function of
  the tree (the basis is static structure, like wavelet names and levels).

The MODWPT follows Percival & Walden's convention (filters scaled by
1/sqrt(2) per stage, à trous spacing ``2^(j-1)`` at depth ``j``), which makes
every stage a tight frame: node energies at each depth sum to the signal
energy (periodic boundary), and synthesis is the exact adjoint.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ..ops.dwt import _bior_parities, convolve_downsample, upsample_convolve
from .modwt import _resolve_discrete, _validate_signal

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

__all__ = [
    "WaveletPacketTree",
    "wpt",
    "iwpt",
    "modwpt",
    "imodwpt",
    "best_basis",
    "basis_coefficients",
    "reconstruct_basis",
    "frequency_order",
    "packet_frequency_bands",
]


class WaveletPacketTree(NamedTuple):
    """Full packet tree: ``levels[j]`` holds the ``2^j`` depth-``j`` nodes.

    Decimated (``wpt``): ``levels[j]`` is ``[..., 2^j, N / 2^j]``.
    Undecimated (``modwpt``): ``levels[j]`` is ``[..., 2^j, N]``.
    ``levels[0]`` is the input signal as the single root node
    (``[..., 1, N]``).  Nodes are in NATURAL (Paley) order: the children of
    node ``i`` are ``2i`` (lowpass branch) and ``2i+1`` (highpass branch);
    use :func:`frequency_order` for spectrally ascending leaves.
    """

    levels: tuple[jnp.ndarray, ...]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def is_decimated(self) -> bool:
        return self.depth >= 1 and (
            self.levels[1].shape[-1] != self.levels[0].shape[-1]
        )

    def node(self, level: int, index: int) -> jnp.ndarray:
        """Coefficients of node ``(level, index)``, shape ``[..., N_level]``."""
        return self.levels[level][..., index, :]

    @property
    def leaves(self) -> jnp.ndarray:
        """Deepest-level nodes, natural order: ``[..., 2^J, N_J]``."""
        return self.levels[-1]

    def energy_map(self, level: int | None = None) -> jnp.ndarray:
        """Per-node energies ``[..., 2^level]`` (defaults to the leaf level)."""
        lvl = self.depth if level is None else level
        return (self.levels[lvl] ** 2).sum(axis=-1)


def _validate_depth(levels: int) -> None:
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"packet depth must be >= 1, got {levels}",
        )


# ---------------------------------------------------------------------------
# Decimated WPT
# ---------------------------------------------------------------------------


def wpt(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacketTree:
    """Decimated wavelet packet decomposition to depth ``levels``.

    Each depth applies ``dwt`` to EVERY node (approx and detail alike);
    requires ``N`` divisible by ``2^levels``.  Boundaries: periodic (exact
    perfect reconstruction) or zero.
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _validate_signal(x, min_length=2)
    n = x.shape[-1]
    if n % (1 << levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"WPT depth {levels} requires length divisible by {1 << levels}, "
            f"got {n}",
            suggestions=("Pad the signal or lower the depth",),
        )
    p_h, p_g = _bior_parities(w)
    nodes = x[..., None, :]
    tree = [nodes]
    for _ in range(levels):
        lo = convolve_downsample(nodes, w.dec_lo, boundary=boundary, offset=p_h)
        hi = convolve_downsample(nodes, w.dec_hi, boundary=boundary, offset=p_g)
        # interleave: children (2i, 2i+1) of node i
        nodes = jnp.stack([lo, hi], axis=-2).reshape(
            nodes.shape[:-2] + (2 * nodes.shape[-2], nodes.shape[-1] // 2)
        )
        tree.append(nodes)
    return WaveletPacketTree(tuple(tree))


def _iwpt_pair(nodes: jnp.ndarray, w, boundary: str) -> jnp.ndarray:
    """One synthesis stage: ``[..., 2M, n]`` children -> ``[..., M, 2n]``."""
    p_h, p_g = _bior_parities(w)
    pairs = nodes.reshape(nodes.shape[:-2] + (nodes.shape[-2] // 2, 2, nodes.shape[-1]))
    lo = pairs[..., 0, :]
    hi = pairs[..., 1, :]
    n_out = 2 * nodes.shape[-1]
    return upsample_convolve(
        lo, w.rec_lo, n_out, boundary=boundary, offset=p_h
    ) + upsample_convolve(hi, w.rec_hi, n_out, boundary=boundary, offset=p_g)


def iwpt(
    tree: WaveletPacketTree | jnp.ndarray,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Invert a decimated packet tree from its leaves ``[..., 2^J, N/2^J]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacketTree) else tree
    while nodes.shape[-2] > 1:
        nodes = _iwpt_pair(nodes, w, boundary)
    return nodes[..., 0, :]


# ---------------------------------------------------------------------------
# Undecimated MODWPT
# ---------------------------------------------------------------------------


def modwpt(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacketTree:
    """Undecimated (maximal-overlap) packet decomposition to depth ``levels``.

    Every node keeps length ``N``; depth ``j`` filters with à trous spacing
    ``2^(j-1)`` and per-stage 1/sqrt(2) scaling, so depth-``j`` node energies
    sum to the signal energy (periodic, orthogonal wavelets).
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _validate_signal(x, min_length=2)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    nodes = x[..., None, :]
    tree = [nodes]
    for j in range(1, levels + 1):
        spacing = 1 << (j - 1)
        lo, hi = atrous_analysis_pair(
            nodes, low, high, spacing=spacing, boundary=boundary
        )
        nodes = jnp.stack([lo, hi], axis=-2).reshape(
            nodes.shape[:-2] + (2 * nodes.shape[-2], nodes.shape[-1])
        )
        tree.append(nodes)
    return WaveletPacketTree(tuple(tree))


def _imodwpt_pair(
    nodes: jnp.ndarray, w, spacing: int, boundary: str
) -> jnp.ndarray:
    """One adjoint synthesis stage at the given à trous spacing."""
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    pairs = nodes.reshape(nodes.shape[:-2] + (nodes.shape[-2] // 2, 2, nodes.shape[-1]))
    rec_lo = atrous_convolve(
        pairs[..., 0, :], low, spacing=spacing, boundary=boundary, sign=+1
    )
    rec_hi = atrous_convolve(
        pairs[..., 1, :], high, spacing=spacing, boundary=boundary, sign=+1
    )
    return rec_lo + rec_hi


def imodwpt(
    tree: WaveletPacketTree | jnp.ndarray,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Invert an undecimated packet tree from its leaves ``[..., 2^J, N]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacketTree) else tree
    depth = int(round(math.log2(nodes.shape[-2])))
    if (1 << depth) != nodes.shape[-2]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"leaf node count must be a power of two, got {nodes.shape[-2]}",
        )
    for j in range(depth, 0, -1):
        nodes = _imodwpt_pair(nodes, w, 1 << (j - 1), boundary)
    return nodes[..., 0, :]


# ---------------------------------------------------------------------------
# Frequency (sequency) ordering
# ---------------------------------------------------------------------------


def frequency_order(level: int) -> np.ndarray:
    """Natural-order indices arranged by ascending passband frequency.

    ``tree.levels[level][..., frequency_order(level), :]`` is spectrally
    ascending.  Recursion: a parent sitting at an EVEN frequency position
    passes its band through un-mirrored (lowpass child first); at an ODD
    position decimation/aliasing mirrors the band, so the children swap —
    the classic Gray-code permutation of the Paley order.
    """
    order = [0]
    for _ in range(level):
        nxt: list[int] = []
        for pos, natural in enumerate(order):
            if pos % 2 == 0:
                nxt.extend((2 * natural, 2 * natural + 1))
            else:
                nxt.extend((2 * natural + 1, 2 * natural))
        order = nxt
    return np.asarray(order, dtype=np.int64)


def packet_frequency_bands(
    level: int, sampling_rate: float = 1.0
) -> np.ndarray:
    """``[2^level, 2]`` (low, high) frequency edges per NATURAL-order node."""
    n_nodes = 1 << level
    width = sampling_rate / 2.0 / n_nodes
    bands = np.empty((n_nodes, 2))
    for freq_pos, natural in enumerate(frequency_order(level)):
        bands[natural] = (freq_pos * width, (freq_pos + 1) * width)
    return bands


# ---------------------------------------------------------------------------
# Best basis (Coifman–Wickerhauser)
# ---------------------------------------------------------------------------

_EPS = 1e-30


def _cost_table(
    tree: WaveletPacketTree, cost: str | Callable, threshold: float
) -> list[np.ndarray]:
    """Additive information cost per node, summed over batch axes (host)."""
    if callable(cost):
        return [
            np.asarray(
                jnp.vectorize(cost, signature="(n)->()")(lvl).sum(
                    axis=tuple(range(lvl.ndim - 2))
                )
            )
            for lvl in tree.levels
        ]
    root_energy = float(jnp.sum(tree.levels[0] ** 2)) + _EPS
    tables = []
    for lvl in tree.levels:
        p = lvl**2 / root_energy
        if cost == "shannon":
            node_cost = -(p * jnp.log(p + _EPS)).sum(axis=-1)
        elif cost == "log_energy":
            node_cost = jnp.log(p + _EPS).sum(axis=-1)
        elif cost == "threshold":
            node_cost = (jnp.abs(lvl) > threshold).sum(axis=-1).astype(jnp.float32)
        elif cost == "risk":
            # Donoho-Johnstone oracle-risk proxy for thresholded estimation:
            # sum min(c^2, t^2) — rewards CONCENTRATING signal above t (each
            # big coefficient costs only t^2) instead of hiding it below.
            node_cost = jnp.minimum(lvl**2, threshold**2).sum(axis=-1)
        elif cost == "l1":
            node_cost = jnp.abs(lvl).sum(axis=-1)
        else:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"unknown cost {cost!r}",
                suggestions=("Use shannon, log_energy, threshold, risk, l1, "
                             "or a callable node -> scalar"),
            )
        tables.append(np.asarray(node_cost.sum(axis=tuple(range(node_cost.ndim - 1)))))
    return tables


def best_basis(
    tree: WaveletPacketTree,
    cost: str | Callable = "shannon",
    *,
    threshold: float = 1.0,
) -> tuple[tuple[int, int], ...]:
    """Minimal-cost admissible basis as ``((level, natural_index), ...)``.

    Bottom-up dynamic program: a node is kept whole if its own cost is at
    most the best total cost of its two subtrees, else it is split.  Costs
    are additive over nodes ("shannon" = -sum p log p with p the per-sample
    energy fraction of the ROOT energy; "log_energy"; "threshold" = count of
    samples above ``threshold``; "l1"; or any callable mapping a node's
    coefficient vector to a scalar).  Batched inputs are selected jointly
    (costs summed over batch axes).
    """
    tables = _cost_table(tree, cost, threshold)
    depth = tree.depth
    best_cost = tables[depth].astype(np.float64).copy()
    choice: list[np.ndarray] = [None] * (depth + 1)  # type: ignore[list-item]
    choice[depth] = np.ones(1 << depth, dtype=bool)  # leaves: keep
    for j in range(depth - 1, -1, -1):
        own = tables[j].astype(np.float64)
        children = best_cost.reshape(-1, 2).sum(axis=1)
        keep = own <= children
        choice[j] = keep
        best_cost = np.where(keep, own, children)
    basis: list[tuple[int, int]] = []

    def _collect(level: int, idx: int) -> None:
        if choice[level][idx]:
            basis.append((level, idx))
        else:
            _collect(level + 1, 2 * idx)
            _collect(level + 1, 2 * idx + 1)

    _collect(0, 0)
    return tuple(basis)


def basis_coefficients(
    tree: WaveletPacketTree, basis: Sequence[tuple[int, int]]
) -> list[jnp.ndarray]:
    """Coefficient vectors of the chosen basis nodes, in ``basis`` order."""
    return [tree.node(level, idx) for level, idx in basis]


def reconstruct_basis(
    tree: WaveletPacketTree,
    basis: Sequence[tuple[int, int]],
    wavelet,
    *,
    boundary: str = "periodic",
    transform_nodes: Callable | None = None,
) -> jnp.ndarray:
    """Reconstruct the signal from an admissible basis selection.

    ``transform_nodes(level, index, coeffs) -> coeffs`` optionally edits each
    basis node before synthesis (thresholding, band suppression, ...) — the
    packet-domain analogue of the functional coefficient editing on
    ``MultiLevelMODWTResult``.
    """
    w = _resolve_discrete(wavelet)
    _validate_basis(basis, tree.depth)
    chosen = dict()
    for level, idx in basis:
        coeffs = tree.node(level, idx)
        if transform_nodes is not None:
            coeffs = transform_nodes(level, idx, coeffs)
        chosen[(level, idx)] = coeffs
    decimated = tree.is_decimated

    def _synth(level: int, idx: int) -> jnp.ndarray:
        if (level, idx) in chosen:
            return chosen[(level, idx)]
        lo = _synth(level + 1, 2 * idx)
        hi = _synth(level + 1, 2 * idx + 1)
        pair = jnp.stack([lo, hi], axis=-2)
        if decimated:
            return _iwpt_pair(pair, w, boundary)[..., 0, :]
        return _imodwpt_pair(pair, w, 1 << level, boundary)[..., 0, :]

    return _synth(0, 0)


def _validate_basis(basis: Sequence[tuple[int, int]], depth: int) -> None:
    """An admissible basis covers [0, 1) exactly once in dyadic intervals."""
    intervals = []
    for level, idx in basis:
        if not (0 <= level <= depth) or not (0 <= idx < (1 << level)):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"node ({level}, {idx}) outside the tree (depth {depth})",
            )
        width = 1.0 / (1 << level)
        intervals.append((idx * width, (idx + 1) * width))
    intervals.sort()
    pos = 0.0
    for lo, hi in intervals:
        if abs(lo - pos) > 1e-12:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "basis nodes overlap or leave gaps — not an admissible "
                "packet basis",
            )
        pos = hi
    if abs(pos - 1.0) > 1e-12:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "basis does not cover the whole tree",
        )
