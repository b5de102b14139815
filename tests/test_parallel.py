"""Sharded/tiled transforms on the virtual 8-device CPU mesh.

The analogue of the reference's ``ParallelVsSequentialEquivalenceTest``:
sharded and tiled execution must match single-device output to machine
precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.parallel import (
    default_mesh,
    imodwt_multilevel_tiled,
    make_mesh,
    modwt_multilevel_sharded_batch,
    modwt_multilevel_tiled,
    shard_batch,
)
from .conftest import composite_sin


@pytest.fixture(scope="module")
def signal_mesh():
    return make_mesh({"signal": 8})


@pytest.fixture(scope="module")
def mesh_2d():
    return make_mesh({"data": 2, "signal": 4})


def test_mesh_helpers():
    mesh = default_mesh()
    assert mesh.shape["data"] == 8
    with pytest.raises(vw.InvalidArgumentError):
        make_mesh({"data": 64})


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_tiled_forward_equals_single_device(signal_mesh, boundary):
    x = jnp.asarray(composite_sin(1024, noise_std=0.3))
    tiled = modwt_multilevel_tiled(
        x, "db4", levels=4, mesh=signal_mesh, boundary=boundary
    )
    single = vw.modwt_multilevel(x, "db4", levels=4, boundary=boundary)
    for a, b in zip(tiled.details, single.details):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(tiled.approx), np.asarray(single.approx), atol=1e-12
    )


def test_tiled_roundtrip_periodic_exact(signal_mesh):
    x = jnp.asarray(composite_sin(1024, noise_std=0.2))
    res = modwt_multilevel_tiled(x, "sym8", levels=2, mesh=signal_mesh)
    xr = imodwt_multilevel_tiled(res, "sym8", mesh=signal_mesh)
    assert float(jnp.max(jnp.abs(xr - x))) < 1e-10


def test_tiled_inverse_matches_single_device_zero(signal_mesh):
    x = jnp.asarray(composite_sin(512, noise_std=0.2))
    res = modwt_multilevel_tiled(x, "db4", levels=3, mesh=signal_mesh, boundary="zero")
    xr = imodwt_multilevel_tiled(res, "db4", mesh=signal_mesh, boundary="zero")
    single = vw.imodwt_multilevel(
        vw.modwt_multilevel(x, "db4", levels=3, boundary="zero"), "db4", boundary="zero"
    )
    np.testing.assert_allclose(np.asarray(xr), np.asarray(single), atol=1e-12)


@pytest.mark.parametrize("wavelet,levels", [("db4", 3), ("sym8", 1), ("haar", 4)])
def test_tiled_symmetric_inverse_matches_single_device(signal_mesh, wavelet, levels):
    """Tiled symmetric synthesis (two-sided tau-offset halos) must bit-match
    the single-device alignment-table inverse."""
    x = jnp.asarray(composite_sin(512, noise_std=0.2))
    res = modwt_multilevel_tiled(
        x, wavelet, levels=levels, mesh=signal_mesh, boundary="symmetric"
    )
    xr = imodwt_multilevel_tiled(res, wavelet, mesh=signal_mesh, boundary="symmetric")
    single = vw.imodwt_multilevel(
        vw.modwt_multilevel(x, wavelet, levels=levels, boundary="symmetric"),
        wavelet,
        boundary="symmetric",
    )
    np.testing.assert_allclose(np.asarray(xr), np.asarray(single), atol=1e-12)


def test_tiled_symmetric_deep_halo_matches_single_device(signal_mesh):
    """Halo wider than the shard (db4 level 5-6: halo 112/224 > 64): the
    mirror must come from the gathered global head, not the local shard
    (advisor round-1 finding — was 4.3e-1 max error)."""
    x = jnp.asarray(composite_sin(512, noise_std=0.3))
    for levels in (5, 6):
        tiled = modwt_multilevel_tiled(
            x, "db4", levels=levels, mesh=signal_mesh, boundary="symmetric"
        )
        single = vw.modwt_multilevel(x, "db4", levels=levels, boundary="symmetric")
        for a, b in zip(tiled.details, single.details):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(tiled.approx), np.asarray(single.approx), atol=1e-12
        )


def test_tiled_symmetric_deep_halo_inverse(signal_mesh):
    """Symmetric inverse with per-branch halos wider than the shard."""
    x = jnp.asarray(composite_sin(512, noise_std=0.2))
    res = modwt_multilevel_tiled(
        x, "db4", levels=5, mesh=signal_mesh, boundary="symmetric"
    )
    xr = imodwt_multilevel_tiled(res, "db4", mesh=signal_mesh, boundary="symmetric")
    single = vw.imodwt_multilevel(
        vw.modwt_multilevel(x, "db4", levels=5, boundary="symmetric"),
        "db4",
        boundary="symmetric",
    )
    np.testing.assert_allclose(np.asarray(xr), np.asarray(single), atol=1e-12)


def test_tiled_uneven_shards_rejected(signal_mesh):
    with pytest.raises(vw.InvalidArgumentError):
        modwt_multilevel_tiled(
            jnp.zeros(1001), "db4", levels=2, mesh=signal_mesh
        )


def test_multihop_halo(signal_mesh):
    """Halo wider than one shard: level-4 db8 needs (16-1)*8 = 120 > 32."""
    x = jnp.asarray(composite_sin(256, noise_std=0.1))
    tiled = modwt_multilevel_tiled(x, "db8", levels=4, mesh=signal_mesh)
    single = vw.modwt_multilevel(x, "db8", levels=4)
    for a, b in zip(tiled.details, single.details):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_batched_tiled_2d_mesh(mesh_2d):
    batch = np.stack([composite_sin(512, seed=s, noise_std=0.1) for s in range(4)])
    x = jnp.asarray(batch)
    tiled = modwt_multilevel_tiled(x, "db4", levels=3, mesh=mesh_2d)
    single = vw.modwt_multilevel(x, "db4", levels=3)
    np.testing.assert_allclose(
        np.asarray(tiled.approx), np.asarray(single.approx), atol=1e-12
    )


def test_sharded_batch_facade(mesh_2d):
    batch = np.stack([composite_sin(256, seed=s) for s in range(4)])
    res = modwt_multilevel_sharded_batch(
        jnp.asarray(batch), "db4", levels=3, mesh=mesh_2d, axis="data"
    )
    single = vw.modwt_multilevel(jnp.asarray(batch), "db4", levels=3)
    np.testing.assert_allclose(
        np.asarray(res.details[0]), np.asarray(single.details[0]), atol=1e-12
    )
    sharded = shard_batch(jnp.asarray(batch), mesh_2d)
    assert sharded.sharding.spec[0] == "data"


def test_multihost_mesh_and_parity():
    """("host","chip") mesh: batch over hosts, signal over chips — output
    must bit-match the single-device transform for every boundary mode."""
    from vectorwave_tpu.parallel import (
        imodwt_multilevel_multihost,
        make_multihost_mesh,
        modwt_multilevel_multihost,
    )

    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    assert mesh.shape == {"host": 2, "chip": 4}
    batch = np.stack([composite_sin(512, seed=s, noise_std=0.2) for s in range(4)])
    x = jnp.asarray(batch)
    for boundary in ("periodic", "zero", "symmetric"):
        res = modwt_multilevel_multihost(
            x, "db4", levels=3, mesh=mesh, boundary=boundary
        )
        single = vw.modwt_multilevel(x, "db4", levels=3, boundary=boundary)
        for a, b in zip(res.details, single.details):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(res.approx), np.asarray(single.approx), atol=1e-12
        )
        xr = imodwt_multilevel_multihost(res, "db4", mesh=mesh, boundary=boundary)
        single_inv = vw.imodwt_multilevel(single, "db4", boundary=boundary)
        np.testing.assert_allclose(np.asarray(xr), np.asarray(single_inv), atol=1e-11)


def test_multihost_batch_stays_sharded():
    """The transform must not gather the batch over the host axis: output
    sharding keeps the leading axis on "host"."""
    from vectorwave_tpu.parallel import make_multihost_mesh, modwt_multilevel_multihost

    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    x = jnp.asarray(np.stack([composite_sin(512, seed=s) for s in range(4)]))
    res = modwt_multilevel_multihost(x, "haar", levels=2, mesh=mesh)
    spec = res.approx.sharding.spec
    assert spec[0] == "host" and spec[-1] == "chip"


def test_multihost_validation():
    from vectorwave_tpu.parallel import make_multihost_mesh, modwt_multilevel_multihost

    with pytest.raises(vw.InvalidArgumentError):
        make_multihost_mesh(n_hosts=16)
    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    with pytest.raises(vw.InvalidArgumentError):  # 1-D input
        modwt_multilevel_multihost(jnp.zeros(512), "db4", levels=2, mesh=mesh)
    with pytest.raises(vw.InvalidArgumentError):  # batch not divisible by hosts
        modwt_multilevel_multihost(jnp.zeros((3, 512)), "db4", levels=2, mesh=mesh)


def test_communication_report():
    from vectorwave_tpu.parallel import communication_report, make_multihost_mesh

    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    rep = communication_report(mesh, "db4", levels=3, n=4096, batch=4)
    # db4: L0=8 -> halos 7, 14, 28
    assert rep.per_level_halo_samples == (7, 14, 28)
    assert rep.host_bytes_per_host == 0
    assert rep.halo_bytes_per_chip == (7 + 14 + 28) * 2 * 4  # local_batch=2, f32
    assert 0 < rep.halo_fraction_of_compute_bytes < 1
    two_sided = communication_report(
        mesh, "db4", levels=3, n=4096, batch=4, direction="inverse_symmetric"
    )
    assert two_sided.halo_bytes_per_chip == 2 * rep.halo_bytes_per_chip


def test_graft_entry_dryrun():
    import __graft_entry__ as graft

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    graft.dryrun_multichip(8)


def test_multihost_collectives_stay_on_ici():
    """Structural zero-DCN guarantee: every collective-permute in the
    compiled multihost program exchanges data only WITHIN a host row —
    nothing crosses the "host" axis during the transform."""
    import re

    from vectorwave_tpu.parallel import make_multihost_mesh
    from vectorwave_tpu.parallel.multihost import CHIP_AXIS, HOST_AXIS
    from vectorwave_tpu.parallel.tiled import modwt_multilevel_tiled

    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    dev_host = {}  # device id -> host row
    grid = np.asarray(mesh.devices)
    for h in range(grid.shape[0]):
        for d in grid[h]:
            dev_host[d.id] = h

    x = jnp.zeros((4, 512), dtype=jnp.float32)

    def fn(v):
        return modwt_multilevel_tiled(
            v, "db4", levels=3, mesh=mesh, axis=CHIP_AXIS,
            boundary="periodic", batch_axis=HOST_AXIS,
        ).approx

    compiled = jax.jit(fn).lower(x).compile()
    hlo = compiled.as_text()
    pairs = re.findall(r"source_target_pairs=\{([0-9,{} ]+)\}", hlo)
    assert pairs, "expected at least one collective-permute (halo exchange)"
    for group in pairs:
        for pair in re.findall(r"\{(\d+),(\d+)\}", group):
            a, b = int(pair[0]), int(pair[1])
            assert dev_host[a] == dev_host[b], (
                f"collective-permute {a}->{b} crosses host rows"
            )
    # and nothing else communicates: no all-reduce/all-gather across hosts
    for coll in re.findall(r"replica_groups=\{\{([0-9,{} ]*)\}\}", hlo):
        for grp in coll.split("},{"):
            ids = [int(t) for t in re.findall(r"\d+", grp)]
            hosts = {dev_host[i] for i in ids}
            assert len(hosts) == 1, f"collective group {ids} spans hosts"


def test_sharded_batch_analysis_modules():
    """The beyond-reference analysis modules (packets, variance, coherence,
    SST) run unchanged over a batch axis sharded across the mesh — parity
    with the unsharded result, no code changes needed (pure functions over
    arrays)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import vectorwave_tpu as vw
    from vectorwave_tpu.transforms.cwt import scales_log

    mesh = make_mesh({"data": 8})
    rng = np.random.default_rng(50)
    xb = jnp.asarray(rng.standard_normal((8, 1024)))
    xs = jax.device_put(xb, NamedSharding(mesh, P("data", None)))

    leaves = jax.jit(lambda z: vw.modwpt(z, "db4", 3).leaves)
    np.testing.assert_allclose(
        np.asarray(leaves(xs)), np.asarray(leaves(xb)), atol=1e-12
    )

    var = jax.jit(lambda z: vw.wavelet_variance(z, "db4", 4).variance)
    np.testing.assert_allclose(np.asarray(var(xs)), np.asarray(var(xb)), atol=1e-12)

    scales = scales_log(2, 32, 8)
    yb = jnp.asarray(rng.standard_normal((8, 1024)))
    ys = jax.device_put(yb, NamedSharding(mesh, P("data", None)))
    coh = jax.jit(lambda a, b: vw.wavelet_coherence(a, b, scales, "morl").coherence)
    np.testing.assert_allclose(
        np.asarray(coh(xs, ys)), np.asarray(coh(xb, yb)), atol=1e-10
    )

    sst = jax.jit(lambda z: jnp.abs(vw.synchrosqueeze(z, scales, "morl").coeffs))
    np.testing.assert_allclose(np.asarray(sst(xs)), np.asarray(sst(xb)), atol=1e-10)

    ridge = jax.jit(
        lambda z: vw.extract_ridge(
            type(vw.cross_wavelet(z, z, scales, "morl"))(
                jnp.abs(vw.cross_wavelet(z, z, scales, "morl").coeffs) + 1e-6,
                scales,
                "zero",
            )
        ).indices
    )
    np.testing.assert_array_equal(np.asarray(ridge(xs)), np.asarray(ridge(xb)))


@pytest.mark.slow
def test_sharded_batch_sparse_solvers():
    """The FISTA sparse solvers run unchanged over a sharded batch axis —
    the fori_loop carry keeps the input sharding, so parity with the
    unsharded solve is exact (pure functions over arrays)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import vectorwave_tpu as vw

    mesh = make_mesh({"data": 8})
    rng = np.random.default_rng(51)
    xb = jnp.asarray(rng.standard_normal((8, 512)), jnp.float32)
    xs = jax.device_put(xb, NamedSharding(mesh, P("data", None)))

    # f32 reduction-order differences across shardings compound over the
    # FISTA iterations -> machine-precision (not bit-exact) parity contract
    bp = jax.jit(lambda z: vw.bpdn(z, "db4", levels=3, steps=15).signal)
    np.testing.assert_allclose(np.asarray(bp(xs)), np.asarray(bp(xb)), atol=1e-4)

    mask = jnp.asarray(rng.random(512) > 0.3, jnp.float32)
    inp = jax.jit(
        lambda z: vw.inpaint(z * mask, mask, "db4", levels=3, steps=20)
    )
    np.testing.assert_allclose(np.asarray(inp(xs)), np.asarray(inp(xb)), atol=1e-4)


# ---------------------------------------------------------------------------
# Tiled path at float64 against the single-device transform, and the
# backend option that is left ('auto' == 'jnp'; the kernel tier is gone).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_tiled_pallas_matches_fused_kernel(signal_mesh, boundary):
    """Tiled analysis/synthesis == the single-device transform (float64)."""
    x = jnp.asarray(composite_sin(2048, noise_std=0.3), dtype=jnp.float64)
    tiled = modwt_multilevel_tiled(
        x, "db4", levels=3, mesh=signal_mesh, boundary=boundary,
    )
    ref = vw.modwt_multilevel(x, "db4", levels=3, boundary=boundary)
    for a, b in zip(tiled.details + (tiled.approx,), ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    xr = imodwt_multilevel_tiled(
        tiled, "db4", mesh=signal_mesh, boundary=boundary,
    )
    xr_ref = vw.imodwt_multilevel(ref, "db4", boundary=boundary)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(xr_ref), atol=1e-12)
    if boundary == "periodic":
        np.testing.assert_allclose(np.asarray(xr), np.asarray(x), atol=1e-12)


def test_tiled_pallas_deep_halo_and_batch(mesh_2d):
    """Cumulative halo wider than a shard (multi-hop ppermute) + a batched
    2-D mesh."""
    rng = np.random.default_rng(5)
    xb = jnp.asarray(rng.standard_normal((4, 512)), dtype=jnp.float32)
    # span = (16-1)(2^4-1) = 225 > 512/4 = 128 samples/shard -> 2 hops
    tiled = modwt_multilevel_tiled(
        xb, "db8", levels=4, mesh=mesh_2d, axis="signal", batch_axis="data",
    )
    ref = vw.modwt_multilevel(xb, "db8", levels=4)
    for a, b in zip(tiled.details + (tiled.approx,), ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    xr = imodwt_multilevel_tiled(
        tiled, "db8", mesh=mesh_2d, axis="signal", batch_axis="data",
    )
    np.testing.assert_allclose(np.asarray(xr), np.asarray(xb), atol=1e-5)


def test_tiled_backend_validation(signal_mesh):
    x = jnp.zeros(1024, dtype=jnp.float32)
    for backend in ("cuda", "pallas"):
        with pytest.raises(vw.InvalidArgumentError):
            modwt_multilevel_tiled(
                x, "db4", levels=2, mesh=signal_mesh, backend=backend
            )
    res = modwt_multilevel_tiled(x, "db4", levels=2, mesh=signal_mesh,
                                 backend="jnp")
    with pytest.raises(vw.InvalidArgumentError):
        imodwt_multilevel_tiled(res, "db4", mesh=signal_mesh,
                                backend="pallas")
