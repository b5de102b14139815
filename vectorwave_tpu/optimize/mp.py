"""Matching pursuit over a continuous-wavelet dictionary (Mallat-Zhang).

Beyond-reference capability: greedy adaptive decomposition of a signal into
a few wavelet atoms ``x ~ sum_k c_k psi_{s_k}(t - tau_k)``.  Where the CWT
*describes* energy over (scale, shift), matching pursuit *selects* — each
step picks the single atom with the largest normalized correlation against
the current residual, subtracts its projection, and repeats; residual energy
decreases monotonically (Mallat & Zhang 1993) and the chosen (scale, shift,
coefficient) triples are a sparse, readable summary (transients,
oscillatory bursts, their amplitudes).

Design: the whole pursuit is ONE jitted ``lax.fori_loop``.

* All correlations at once: one ``irfft(rfft(res) * conj(bank))`` gives
  ``<res, atom(s, tau)>`` for EVERY scale and shift — the periodic CWT
  reused as the greedy search engine (no per-atom loops).
* Atom selection is a flat on-device argmax over the [S, N] correlation
  surface (per batch element), and the atom itself is synthesized in the
  frequency domain (``irfft(rfft(row) * phase(tau))``) — no gathers over a
  materialized [S, N, N] dictionary.
* Static shapes: ``steps`` is a trace-time constant; batched inputs run the
  pursuit independently per element inside the same program.

Periodic boundary (the dictionary is circularly shifted); real wavelets
only (mexh, gausN, dog, morl-real...) — complex atoms would need conjugate
pair bookkeeping that belongs in a synchrosqueezing/ridge workflow instead
(see :mod:`..transforms.sst`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.cwt import _resolve_continuous, _sample_bank, validate_scales

__all__ = ["MPResult", "matching_pursuit"]


class MPResult(NamedTuple):
    """Greedy decomposition: per-step atom parameters plus the split signal.

    ``scale_indices``/``shifts``/``coeffs`` are ``[..., steps]`` (coefficient
    of the UNIT-NORM atom — its magnitude is the amplitude captured at that
    step); ``energies`` is the residual energy after each step; ``approx +
    residual == x`` to machine precision at every prefix.
    """

    scale_indices: jnp.ndarray
    shifts: jnp.ndarray
    coeffs: jnp.ndarray
    energies: jnp.ndarray
    approx: jnp.ndarray
    residual: jnp.ndarray
    scales: tuple

    def atom_scales(self) -> jnp.ndarray:
        """Selected scale values ``[..., steps]`` (from ``scale_indices``)."""
        return jnp.asarray(np.asarray(self.scales))[self.scale_indices]


def matching_pursuit(
    x: jnp.ndarray,
    scales,
    wavelet="mexh",
    *,
    steps: int = 32,
) -> MPResult:
    """Run ``steps`` greedy iterations of matching pursuit on ``[..., N]``."""
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    if steps < 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"steps must be >= 1, got {steps}"
        )
    if x.ndim < 1 or x.shape[-1] < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"matching_pursuit needs [..., N>=2] input, got {tuple(x.shape)}",
        )
    n = x.shape[-1]
    bank_np, is_complex = _sample_bank(w, scales, n)
    if is_complex:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"matching_pursuit needs a REAL wavelet, got '{w.name}'",
            suggestions=("Use mexh, gaus1-8, dog, or morl",),
        )
    bank_np = bank_np.real
    norms_np = np.linalg.norm(bank_np, axis=-1)
    if (norms_np < 1e-30).any():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "dictionary contains a zero-norm atom (scale too small for psi)",
        )

    real_dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float64
    x = x.astype(real_dtype)
    lead = x.shape[:-1]
    xb = x.reshape((-1, n))
    batch = xb.shape[0]
    n_scales = len(scales)
    k_freq = n // 2 + 1

    spec = jnp.asarray(np.fft.rfft(bank_np, axis=-1))  # [S, K]
    spec_conj = jnp.conj(spec)
    norms = jnp.asarray(norms_np, dtype=real_dtype)  # [S]
    freqs = jnp.arange(k_freq, dtype=real_dtype)  # rfft bin index

    def step(_, carry):
        res, approx, s_arr, t_arr, c_arr, e_arr, k = carry
        corr = jnp.fft.irfft(
            jnp.fft.rfft(res, axis=-1)[:, None, :] * spec_conj[None], n=n, axis=-1
        )  # [B, S, N]: <res, row shifted by tau>
        z = corr / norms[None, :, None]  # unit-atom correlation
        flat = z.reshape(batch, n_scales * n)
        idx = jnp.argmax(jnp.abs(flat), axis=-1)  # [B]
        s_idx = idx // n
        tau = idx % n
        coeff = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
        # unit atom at (s_idx, tau): row circularly shifted by tau, / norm
        row_spec = jnp.take(spec, s_idx, axis=0)  # [B, K]
        phase = jnp.exp(
            (-2j * jnp.pi / n) * freqs[None, :] * tau[:, None].astype(real_dtype)
        )
        atom = jnp.fft.irfft(row_spec * phase, n=n, axis=-1)
        atom = atom / jnp.take(norms, s_idx)[:, None]
        update = coeff[:, None] * atom
        res = res - update
        approx = approx + update
        return (
            res,
            approx,
            s_arr.at[:, k].set(s_idx.astype(jnp.int32)),
            t_arr.at[:, k].set(tau.astype(jnp.int32)),
            c_arr.at[:, k].set(coeff.astype(real_dtype)),
            e_arr.at[:, k].set((res**2).sum(axis=-1)),
            k + 1,
        )

    init = (
        xb,
        jnp.zeros_like(xb),
        jnp.zeros((batch, steps), dtype=jnp.int32),
        jnp.zeros((batch, steps), dtype=jnp.int32),
        jnp.zeros((batch, steps), dtype=real_dtype),
        jnp.zeros((batch, steps), dtype=real_dtype),
        0,
    )
    res, approx, s_arr, t_arr, c_arr, e_arr, _ = jax.lax.fori_loop(
        0, steps, step, init
    )
    return MPResult(
        s_arr.reshape(lead + (steps,)),
        t_arr.reshape(lead + (steps,)),
        c_arr.reshape(lead + (steps,)),
        e_arr.reshape(lead + (steps,)),
        approx.reshape(lead + (n,)),
        res.reshape(lead + (n,)),
        scales,
    )
