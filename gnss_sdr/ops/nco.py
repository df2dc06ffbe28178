"""Fixed-point numerically-controlled oscillator (NCO) primitives.

Replacement for the reference's float32 phase accumulators
(reference: src/rf/nco_lut.rs:17-42 uses a 2048-entry LUT with an f32
phase accumulator; src/tracking/do_tracking.rs:240-242 wraps carrier phase
with an f32 ``% 2*pi``). Both accumulate rounding error across epochs.

Here phase is a uint32 fraction of a cycle (hardware-NCO style):
``phase_cycles = acc / 2**32``. uint32 arithmetic wraps mod 2**32 by
definition, so phase accumulation across arbitrarily many samples/epochs
is *exact* — no drift, no f64 needed (accelerators run f64 slowly or
not at all). Converting
to radians for sin/cos quantizes at 2**-24 cycles, far below any loop
noise floor.
"""
from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 6.283185307179586
_SCALE = 4294967296.0  # 2**32


def freq_to_step(freq_hz, fs_hz: float):
    """Per-sample phase step as uint32 cycle fraction.

    ``freq_hz`` may be a traced f32 array; ``fs_hz`` is static. Only the
    fractional part of f/fs matters (integer cycles alias away).
    """
    cycles_per_sample = jnp.asarray(freq_hz, jnp.float32) / jnp.float32(fs_hz)
    frac = cycles_per_sample - jnp.floor(cycles_per_sample)
    # f32 -> uint32 conversion is exact for values < 2**32 quantized to
    # the f32 grid; rounding keeps the realized frequency within
    # fs * 2**-25 of the requested one.
    return jnp.round(frac * _SCALE).astype(jnp.uint32)


def phase_ramp(acc_u32, step_u32, n: int):
    """``[..., n]`` uint32 phase ramp: acc + i * step (wrapping).

    ``acc_u32``/``step_u32`` broadcast over leading axes (e.g. channels).
    """
    i = jnp.arange(n, dtype=jnp.uint32)
    acc = jnp.asarray(acc_u32, jnp.uint32)
    step = jnp.asarray(step_u32, jnp.uint32)
    return acc[..., None] + i * step[..., None]


def advance(acc_u32, step_u32, n):
    """Accumulator after ``n`` samples (n may be traced int32)."""
    # force jnp arithmetic: NumPy scalars warn on (intended) wraparound
    acc = jnp.asarray(acc_u32, jnp.uint32)
    step = jnp.asarray(step_u32, jnp.uint32)
    return acc + jnp.asarray(n).astype(jnp.uint32) * step


def to_radians(phase_u32):
    """uint32 cycle fraction -> radians in [0, 2*pi)."""
    return phase_u32.astype(jnp.float32) * jnp.float32(TWO_PI / _SCALE)


def cis(phase_u32):
    """(cos, sin) pair of the phase — e^{+j theta} components."""
    theta = to_radians(phase_u32)
    return jnp.cos(theta), jnp.sin(theta)


def mix_down(re, im, phase_u32):
    """Multiply planar IQ by e^{-j theta(phase)} (downconversion).

    (I + jQ)(cos - j sin) = (I cos + Q sin) + j(Q cos - I sin), matching
    the reference mixer convention (src/rf/nco_lut.rs:8-15).
    """
    c, s = cis(phase_u32)
    return re * c + im * s, im * c - re * s
