"""Checkpoint / resume: persist streaming state with orbax and continue exactly.

Every stateful carry in vectorwave_tpu (block streaming, sliding windows,
per-tick financial analysis) is a NamedTuple pytree of arrays, so it
checkpoints with standard JAX tooling — no bespoke serialization layer.
The reference has no transform checkpointing at all; its streaming state
lives in mutable JVM objects (SURVEY.md §5 "Checkpoint / resume: none").

This demo interrupts a block stream mid-signal, saves the carry with
``orbax.checkpoint``, restores it into a fresh process-equivalent state, and
verifies the resumed run is bit-identical to an uninterrupted one.

Run: python examples/checkpoint_resume_demo.py
"""

import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp

import vectorwave_tpu as vw
from vectorwave_tpu.finance import incremental_wavelet_init, incremental_wavelet_update
from vectorwave_tpu.streaming import modwt_stream_block, streaming_init


def main() -> None:
    rng = np.random.default_rng(7)
    signal = rng.standard_normal(4096).astype(np.float32)
    blocks = [jnp.asarray(signal[i : i + 512]) for i in range(0, 4096, 512)]

    # --- run the first half of a block stream ------------------------------
    state = streaming_init("db4", levels=3)
    first_half = []
    for block in blocks[:4]:
        state, res = modwt_stream_block(state, block, "db4", boundary="zero")
        first_half.append(res)

    # --- checkpoint the carry (it is just a pytree of arrays) --------------
    tmp = tempfile.mkdtemp(prefix="vw_ckpt_")
    ckpt_dir = pathlib.Path(tmp) / "stream_state"
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(ckpt_dir, state)
    checkpointer.wait_until_finished()
    n_files = sum(1 for _ in ckpt_dir.rglob("*") if _.is_file())
    print(f"saved StreamingState -> {ckpt_dir} ({n_files} files)")

    # --- restore into a freshly-initialized template and resume ------------
    template = streaming_init("db4", levels=3)  # shapes/dtypes only
    abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
    restored = checkpointer.restore(ckpt_dir, abstract)
    restored = jax.tree.unflatten(jax.tree.structure(template), jax.tree.leaves(restored))

    second_half = []
    for block in blocks[4:]:
        restored, res = modwt_stream_block(restored, block, "db4", boundary="zero")
        second_half.append(res)

    resumed_d1 = jnp.concatenate([r.details[0] for r in first_half + second_half], axis=-1)

    # --- ground truth 1: an uninterrupted stream (bit-exact contract) ------
    ref_state = streaming_init("db4", levels=3)
    ref_parts = []
    for block in blocks:
        ref_state, res = modwt_stream_block(ref_state, block, "db4", boundary="zero")
        ref_parts.append(res)
    ref_d1 = jnp.concatenate([r.details[0] for r in ref_parts], axis=-1)
    dev = float(jnp.max(jnp.abs(resumed_d1 - ref_d1)))
    print(f"resumed-after-checkpoint vs uninterrupted stream (level-1 detail): {dev:.2e}")
    assert dev == 0.0, "checkpoint/resume must be bit-exact"

    # --- ground truth 2: the whole-signal transform (left-history contract;
    # tolerance covers float32 summation order) -------------------------------
    whole = vw.modwt_multilevel(jnp.asarray(signal), "db4", levels=3, boundary="zero")
    wdev = float(jnp.max(jnp.abs(resumed_d1 - whole.details[0])))
    print(f"resumed stream vs whole-signal transform: {wdev:.2e}")
    assert wdev < 1e-4

    # --- the same recipe works for the per-tick finance carry --------------
    fstate = incremental_wavelet_init()
    prices = 100.0 * np.exp(np.cumsum(rng.normal(0, 1e-3, 256))).astype(np.float32)
    for p in prices[:128]:
        fstate, _ = incremental_wavelet_update(fstate, jnp.float32(p))
    fin_dir = pathlib.Path(tmp) / "finance_state"
    checkpointer.save(fin_dir, fstate)
    checkpointer.wait_until_finished()
    fabstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, incremental_wavelet_init())
    frestored = checkpointer.restore(fin_dir, fabstract)
    frestored = jax.tree.unflatten(
        jax.tree.structure(fstate), jax.tree.leaves(frestored)
    )
    for p in prices[128:]:
        fstate, ref_m = incremental_wavelet_update(fstate, jnp.float32(p))
        frestored, got_m = incremental_wavelet_update(frestored, jnp.float32(p))
    fdev = max(
        float(
            jnp.max(
                jnp.abs(
                    jnp.asarray(a, jnp.float32) - jnp.asarray(b, jnp.float32)
                )
            )
        )
        for a, b in zip(jax.tree.leaves(ref_m), jax.tree.leaves(got_m))
    )
    print(f"finance per-tick metrics after resume, max deviation: {fdev:.2e}")
    assert fdev == 0.0

    print("checkpoint/resume round trips are bit-exact")


if __name__ == "__main__":
    main()
