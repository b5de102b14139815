"""2-D wavelet packets: quadtree decomposition + Coifman-Wickerhauser basis.

Beyond-reference capability (the reference is 1-D only and has no packet
transforms at all); the 2-D packet quadtree is the classical texture-analysis
front end — every subband, not just the pyramid's LL spine, is recursively
split, and a best-basis dynamic program picks the minimal-cost tiling of the
frequency plane.

Design, mirroring :mod:`.packets`:

* the node axis is a leading batch axis: depth ``j`` holds ``4^j`` nodes as
  one ``[..., 4^j, H/2^j, W/2^j]`` array, and one :func:`..twodim.dwt2` call
  splits EVERY node at once (two batched separable passes — never a Python
  loop over nodes);
* the tree is a NamedTuple pytree (jittable, shardable along batch axes);
* best-basis selection compares host-side cost tables (data-dependent
  structure), reconstruction from a chosen basis is a pure jittable
  function of the tree.

Node order is NATURAL (Paley) per axis: the children of node ``i`` are
``4i + k`` with ``k`` = 0:``ll``, 1:``lh``, 2:``hl``, 3:``hh`` (first letter
= filter along H, second = along W, matching :mod:`.twodim`'s convention).
Only the decimated quadtree is provided: an undecimated depth-``J`` packet
tree materialises ``4^J`` full-size planes, which is the wrong
memory/accuracy trade on an HBM-bound chip (use :func:`..twodim
.modwt2_multilevel` for shift-invariant 2-D analysis).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from .modwt import _resolve_discrete
from .packets import _validate_depth, frequency_order
from .twodim import DWT2Result, _check_2d, dwt2, idwt2


class WaveletPacket2DTree(NamedTuple):
    """Quadtree of packet planes: ``levels[j]`` is ``[..., 4^j, H/2^j, W/2^j]``.

    ``levels[0]`` is the input image as the single root node
    ``[..., 1, H, W]``.
    """

    levels: tuple[jnp.ndarray, ...]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def node(self, level: int, index: int) -> jnp.ndarray:
        """Plane of node ``(level, index)``, shape ``[..., H_j, W_j]``."""
        return self.levels[level][..., index, :, :]

    @property
    def leaves(self) -> jnp.ndarray:
        """Deepest level, natural order: ``[..., 4^J, H_J, W_J]``."""
        return self.levels[-1]

    def energy_map(self, level: int | None = None) -> jnp.ndarray:
        """Per-node energies ``[..., 4^level]`` (defaults to the leaf level)."""
        lvl = self.depth if level is None else level
        return (self.levels[lvl] ** 2).sum(axis=(-1, -2))


def wpt2(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacket2DTree:
    """Decimated 2-D packet decomposition to depth ``levels``.

    Requires ``H`` and ``W`` divisible by ``2^levels``.  Boundaries follow
    :func:`..twodim.dwt2`: periodic (exact PR) or zero.
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _check_2d(x, "wpt2")
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    div = 1 << levels
    if h_dim % div or w_dim % div:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"wpt2 depth {levels} requires dims divisible by {div}, "
            f"got {h_dim}x{w_dim}",
            suggestions=("Pad the image or lower the depth",),
        )
    nodes = x[..., None, :, :]
    tree = [nodes]
    for _ in range(levels):
        res = dwt2(nodes, w, boundary=boundary)
        m = nodes.shape[-3]
        # [..., M, 4, h, w] -> children (4i+k) of node i contiguous
        nodes = jnp.stack([res.ll, res.lh, res.hl, res.hh], axis=-3).reshape(
            nodes.shape[:-3] + (4 * m,) + res.ll.shape[-2:]
        )
        tree.append(nodes)
    return WaveletPacket2DTree(tuple(tree))


def _iwpt2_quad(nodes: jnp.ndarray, w, boundary: str) -> jnp.ndarray:
    """One synthesis stage: ``[..., 4M, h, w]`` children -> ``[..., M, 2h, 2w]``."""
    m = nodes.shape[-3] // 4
    quads = nodes.reshape(nodes.shape[:-3] + (m, 4) + nodes.shape[-2:])
    return idwt2(
        DWT2Result(
            quads[..., 0, :, :],
            quads[..., 1, :, :],
            quads[..., 2, :, :],
            quads[..., 3, :, :],
        ),
        w,
        boundary=boundary,
    )


def iwpt2(
    tree: WaveletPacket2DTree | jnp.ndarray,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Invert a packet quadtree from its leaves ``[..., 4^J, H/2^J, W/2^J]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacket2DTree) else tree
    while nodes.shape[-3] > 1:
        nodes = _iwpt2_quad(nodes, w, boundary)
    return nodes[..., 0, :, :]


# ---------------------------------------------------------------------------
# Frequency geometry
# ---------------------------------------------------------------------------


def _axis_natural(index: int, level: int) -> tuple[int, int]:
    """Split a quadtree index into its per-axis (H, W) natural 1-D indices."""
    h_nat = w_nat = 0
    for d in range(level):
        digit = (index >> (2 * (level - 1 - d))) & 3
        h_nat = (h_nat << 1) | (digit >> 1)
        w_nat = (w_nat << 1) | (digit & 1)
    return h_nat, w_nat


def packet_frequency_bands2(
    level: int, sampling_rate: float = 1.0
) -> np.ndarray:
    """``[4^level, 2, 2]`` frequency rectangles per NATURAL-order node.

    ``bands[idx][0]`` is the (low, high) band along H, ``bands[idx][1]``
    along W — each axis ordered by the 1-D sequency (Gray-code) rule of
    :func:`.packets.frequency_order`, since the separable quadtree is the
    tensor product of two 1-D packet trees.
    """
    if level < 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"level must be >= 0, got {level}"
        )
    inv = np.argsort(frequency_order(level))  # natural -> frequency position
    width = sampling_rate / 2.0 / (1 << level)
    bands = np.empty((1 << (2 * level), 2, 2))
    for idx in range(bands.shape[0]):
        h_nat, w_nat = _axis_natural(idx, level)
        for axis, nat in ((0, h_nat), (1, w_nat)):
            pos = int(inv[nat])
            bands[idx, axis] = (pos * width, (pos + 1) * width)
    return bands


# ---------------------------------------------------------------------------
# Best basis (quadtree Coifman-Wickerhauser)
# ---------------------------------------------------------------------------

_EPS = 1e-30


def _cost_table2(
    tree: WaveletPacket2DTree, cost: str | Callable, threshold: float
) -> list[np.ndarray]:
    """Additive cost per node, summed over batch axes (host-side table)."""
    if callable(cost):
        return [
            np.asarray(
                jnp.vectorize(cost, signature="(h,w)->()")(lvl).sum(
                    axis=tuple(range(lvl.ndim - 3))
                )
            )
            for lvl in tree.levels
        ]
    root_energy = float(jnp.sum(tree.levels[0] ** 2)) + _EPS
    tables = []
    for lvl in tree.levels:
        p = lvl**2 / root_energy
        if cost == "shannon":
            node_cost = -(p * jnp.log(p + _EPS)).sum(axis=(-1, -2))
        elif cost == "log_energy":
            node_cost = jnp.log(p + _EPS).sum(axis=(-1, -2))
        elif cost == "threshold":
            node_cost = (
                (jnp.abs(lvl) > threshold).sum(axis=(-1, -2)).astype(jnp.float32)
            )
        elif cost == "risk":
            node_cost = jnp.minimum(lvl**2, threshold**2).sum(axis=(-1, -2))
        elif cost == "l1":
            node_cost = jnp.abs(lvl).sum(axis=(-1, -2))
        else:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"unknown cost {cost!r}",
                suggestions=(
                    "Use shannon, log_energy, threshold, risk, l1, "
                    "or a callable plane -> scalar",
                ),
            )
        tables.append(node_cost.sum(axis=tuple(range(node_cost.ndim - 1))))
    import jax

    return [np.asarray(t) for t in jax.device_get(tables)]


def best_basis2(
    tree: WaveletPacket2DTree,
    cost: str | Callable = "shannon",
    *,
    threshold: float = 1.0,
) -> tuple[tuple[int, int], ...]:
    """Minimal-cost admissible quadtree basis as ``((level, index), ...)``.

    Same bottom-up dynamic program as the 1-D :func:`.packets.best_basis`,
    with four children per node: keep a node whole iff its own cost is at
    most the best total cost of its four subtrees.
    """
    tables = _cost_table2(tree, cost, threshold)
    depth = tree.depth
    best_cost = tables[depth].astype(np.float64).copy()
    choice: list[np.ndarray] = [None] * (depth + 1)  # type: ignore[list-item]
    choice[depth] = np.ones(1 << (2 * depth), dtype=bool)
    for j in range(depth - 1, -1, -1):
        own = tables[j].astype(np.float64)
        children = best_cost.reshape(-1, 4).sum(axis=1)
        keep = own <= children
        choice[j] = keep
        best_cost = np.where(keep, own, children)
    basis: list[tuple[int, int]] = []

    def _collect(level: int, idx: int) -> None:
        if choice[level][idx]:
            basis.append((level, idx))
        else:
            for k in range(4):
                _collect(level + 1, 4 * idx + k)

    _collect(0, 0)
    return tuple(basis)


def basis_coefficients2(
    tree: WaveletPacket2DTree, basis: Sequence[tuple[int, int]]
) -> list[jnp.ndarray]:
    """Planes of the chosen basis nodes, in ``basis`` order."""
    return [tree.node(level, idx) for level, idx in basis]


def reconstruct_basis2(
    tree: WaveletPacket2DTree,
    basis: Sequence[tuple[int, int]],
    wavelet,
    *,
    boundary: str = "periodic",
    transform_nodes: Callable | None = None,
) -> jnp.ndarray:
    """Reconstruct the image from an admissible quadtree basis selection.

    ``transform_nodes(level, index, plane) -> plane`` optionally edits each
    basis node before synthesis (thresholding, band suppression, ...).
    """
    w = _resolve_discrete(wavelet)
    _validate_basis2(basis, tree.depth)
    chosen = {}
    for level, idx in basis:
        plane = tree.node(level, idx)
        if transform_nodes is not None:
            plane = transform_nodes(level, idx, plane)
        chosen[(level, idx)] = plane

    def _synth(level: int, idx: int) -> jnp.ndarray:
        if (level, idx) in chosen:
            return chosen[(level, idx)]
        quad = jnp.stack(
            [_synth(level + 1, 4 * idx + k) for k in range(4)], axis=-3
        )
        return _iwpt2_quad(quad, w, boundary)[..., 0, :, :]

    return _synth(0, 0)


# ---------------------------------------------------------------------------
# Fused best-basis denoise: ONE device program (on-device DP)
# ---------------------------------------------------------------------------

from .._jitcache import BoundedCache

# bounded: long-lived serving processes feeding many distinct shapes must
# not leak one compiled program per shape
_jit_cache: BoundedCache = BoundedCache(128)


def _node_costs(lvl: jnp.ndarray, cost: str, threshold, root_energy,
                axes=(-1, -2)) -> jnp.ndarray:
    """Additive node costs on-device (jit-safe; threshold may be traced)."""
    p = lvl**2 / root_energy
    if cost == "shannon":
        return -(p * jnp.log(p + _EPS)).sum(axis=axes)
    if cost == "log_energy":
        return jnp.log(p + _EPS).sum(axis=axes)
    if cost == "threshold":
        return (jnp.abs(lvl) > threshold).sum(axis=axes).astype(jnp.float32)
    if cost == "risk":
        return jnp.minimum(lvl**2, threshold**2).sum(axis=axes)
    if cost == "l1":
        return jnp.abs(lvl).sum(axis=axes)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG, f"unknown cost {cost!r}",
        suggestions=("Use shannon, log_energy, threshold, risk or l1",),
    )


def _device_best_basis_masks(costs, depth: int, arity: int):
    """On-device Coifman–Wickerhauser DP over per-level ``[arity^j]`` cost
    vectors -> per-level USED masks (a node is used iff kept and no
    ancestor is kept).  Unrolled bottom-up sweep: jit-safe, no host sync,
    no data-dependent program structure.  The DP compares in float64 where
    enabled (CPU/x64 — matching the host DP of ``best_basis2`` bit for bit
    near ties; without x64 this is a no-op downcast)."""
    costs = [c.astype(jnp.float64) for c in costs]
    best = costs[depth]
    keeps: list = [None] * depth
    for j in range(depth - 1, -1, -1):
        children = best.reshape(-1, arity).sum(axis=1)
        keep = costs[j] <= children
        keeps[j] = keep
        best = jnp.where(keep, costs[j], children)
    anc = jnp.zeros((1,), bool)
    used: list = [None] * (depth + 1)
    for j in range(depth):
        used[j] = keeps[j] & ~anc
        anc = jnp.repeat(anc | keeps[j], arity)
    used[depth] = ~anc
    return used


def best_basis_denoise2(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    *,
    threshold,
    cost: str = "shannon",
    cost_threshold: float = 1.0,
    mode: str = "soft",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Best-basis packet denoise as ONE device program.

    An eager composition (``wpt2`` + ``best_basis2`` +
    ``reconstruct_basis2``) pays one dispatch per op, and a host-side DP
    compiles the reconstruction PER BASIS (a fresh compile whenever the
    data changes the chosen basis).  Here everything is one jitted program: the DP runs on device
    over the [4^j] cost vectors (an unrolled bottom-up sweep), the chosen
    basis becomes per-level USED masks (a node is used iff kept and no
    ancestor is kept), and reconstruction is the full masked bottom-up
    synthesis — thresholded node planes weighted by their mask, so unused
    nodes contribute zero.  Identical output, no host sync, no
    data-dependent recompiles.
    """
    import jax

    from ..ops.thresholds import apply_threshold

    w = _resolve_discrete(wavelet)
    depth = levels
    key = ("bb2", w.name, levels, cost, boundary, mode, x.shape,
           str(x.dtype))
    run = _jit_cache.get(key)
    if run is None:
        def _run(z, cth, thr):
            tree = wpt2(z, w, levels, boundary=boundary)
            root_energy = jnp.sum(tree.levels[0] ** 2) + _EPS
            costs = [
                _node_costs(lvl, cost, cth, root_energy).sum(
                    axis=tuple(range(lvl.ndim - 3))
                )
                for lvl in tree.levels
            ]
            used = _device_best_basis_masks(costs, depth, 4)
            # masked bottom-up reconstruction (thresholds on every node
            # plane; the mask zeroes the unused ones)
            def t_masked(j):
                m = used[j].astype(z.dtype)[:, None, None]
                return apply_threshold(tree.levels[j], thr, mode) * m

            val = t_masked(depth)
            for j in range(depth - 1, -1, -1):
                val = _iwpt2_quad(val, w, boundary) + t_masked(j)
            return val[..., 0, :, :]

        run = _jit_cache[key] = jax.jit(_run)
    return run(x, jnp.float32(cost_threshold), jnp.asarray(threshold, x.dtype))


def _validate_basis2(basis: Sequence[tuple[int, int]], depth: int) -> None:
    """An admissible quadtree basis tiles the unit square in dyadic squares."""
    if not basis:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, "empty packet basis"
        )
    max_level = 0
    for level, idx in basis:
        if not (0 <= level <= depth) or not (0 <= idx < (1 << (2 * level))):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"node ({level}, {idx}) outside the quadtree (depth {depth})",
            )
        max_level = max(max_level, level)
    side = 1 << max_level
    cover = np.zeros((side, side), dtype=np.int32)
    for level, idx in basis:
        h_nat, w_nat = _axis_natural(idx, level)
        scale = 1 << (max_level - level)
        cover[
            h_nat * scale : (h_nat + 1) * scale,
            w_nat * scale : (w_nat + 1) * scale,
        ] += 1
    if (cover != 1).any():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "basis nodes overlap or leave gaps — not an admissible "
            "quadtree packet basis",
        )
