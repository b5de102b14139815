"""What the GPU translation left: one XLA path, no kernel tier options, a
compile cache that follows ``JAX_COMPILATION_CACHE_DIR``, and entry points
that refuse to measure without a GPU."""

import os
import re

import jax
import jax.numpy as jnp
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x():
    return jnp.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (2, 512)), jnp.float32
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda: vw.modwt_multilevel(_x(), "db4", levels=3, backend="pallas"),
        lambda: vw.imodwt_multilevel(
            vw.modwt_multilevel(_x(), "db4", levels=3), "db4", backend="pallas"
        ),
        lambda: vw.streaming.StreamingTransform("db4", backend="pallas"),
        lambda: vw.streaming.StreamingDenoiser("db4", backend="pallas"),
    ],
    ids=["modwt", "imodwt", "stream", "denoiser"],
)
def test_pallas_backend_rejected(call):
    with pytest.raises(vw.InvalidArgumentError, match="backend"):
        call()


def test_set_backend_keeps_auto_and_jnp_only():
    with pytest.raises(vw.InvalidConfigurationError):
        vw.set_backend("pallas")
    for name in ("jnp", "auto"):
        vw.set_backend(name)
        assert vw.get_backend() == name
    a = vw.modwt_multilevel(_x(), "db4", levels=3, backend="auto")
    b = vw.modwt_multilevel(_x(), "db4", levels=3, backend="jnp")
    for p, q in zip(a.details + (a.approx,), b.details + (b.approx,)):
        assert bool(jnp.all(p == q))


def test_removed_kernel_tier_names_are_gone():
    for name in ("set_fused_precision", "get_fused_precision",
                 "modwt_roundtrip_fused", "ExactMODWTResult",
                 "modwt_multilevel_exact", "kernels"):
        assert not hasattr(vw, name), name
    assert not hasattr(vw.parallel, "modwt_multilevel_tiled_exact")
    assert not hasattr(config, "set_sigma_estimator")


def test_no_interpreter_or_tpu_kernel_code_in_the_package():
    pattern = re.compile(r"pallas\.tpu|pltpu|pallas_available|interpret")
    hits = []
    for base in ("vectorwave_tpu",):
        for dirpath, _, files in os.walk(os.path.join(ROOT, base)):
            for f in files:
                if not f.endswith((".py", ".cpp")):
                    continue
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    for i, line in enumerate(fh, 1):
                        if pattern.search(line):
                            hits.append(f"{path}:{i}")
    for f in ("bench.py", "bench_full.py", "__graft_entry__.py", "chip_smoke.py"):
        with open(os.path.join(ROOT, f), encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if pattern.search(line):
                    hits.append(f"{f}:{i}")
    assert hits == []


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_follows_env_var(monkeypatch, tmp_path,
                                       restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_inside_the_checkout(monkeypatch,
                                                      restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compilation_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cache_root_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("VECTORWAVE_TPU_CACHE", raising=False)
    assert config.cache_root() == os.path.join(ROOT, ".cache")


@pytest.mark.parametrize("module", ["bench", "bench_full"])
def test_benchmarks_refuse_the_cpu(module, capsys):
    import importlib

    mod = importlib.import_module(module)
    assert mod.main() != 0
    assert "needs a GPU" in capsys.readouterr().err


def test_graft_dryrun_refuses_too_few_devices():
    import __graft_entry__ as graft

    with pytest.raises(ValueError, match="devices"):
        graft.dryrun_multichip(len(jax.devices()) + 1)
