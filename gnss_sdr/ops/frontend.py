"""Digital front end: DC removal, IF mixing, polyphase decimation.

Re-design of the reference's DigitalFrontend
(reference: src/rf/frontend.rs:32-67: 8-lane SIMD deinterleave -> one-pole
IIR DC removal -> 2048-entry LUT NCO mix; resampling and pulse blanking
declared but left TODO at frontend.rs:64-66). Here the whole chain is one
jitted graph over a full block:

  * DC removal: the reference's per-sample IIR (dc_remove.rs:23-29,
    alpha=0.001) is a linear recurrence — here it is evaluated exactly
    via an associative scan (lax.associative_scan over affine maps), not
    a serial loop;
  * mixing: exact uint32 NCO (ops/nco.py) instead of the f32-accumulator
    LUT (nco_lut.rs:17-42);
  * decimation: windowed-sinc low-pass FIR + strided sampling, expressed
    as a reshaped matmul (full f32). This supplies the
    resampler the reference never implemented.

The front end both conditions real SDR streams and (with decimation)
cuts tracking-path sample rates by the decimation factor — the largest
single throughput lever of the receiver.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import nco


def dc_offset_scan(re: jax.Array, im: jax.Array, alpha: float,
                   bias0_re=0.0, bias0_im=0.0):
    """Exact one-pole DC tracker over a block via associative scan.

    bias[i] = (1-a) * bias[i-1] + a * x[i];  out[i] = x[i] - bias[i]
    An affine recurrence y = c*y + d composes associatively as
    (c1*c2, c2*d1 + d2), so the whole block evaluates in O(log n) depth.
    Returns (out_re, out_im, final_bias_re, final_bias_im).
    """
    a = jnp.float32(alpha)
    c = jnp.full_like(re, 1.0 - a)

    def compose(l, r):
        cl, dl = l
        cr, dr = r
        return cl * cr, cr * dl + dr

    def run(x, bias0):
        cs, ds = jax.lax.associative_scan(compose, (c, a * x))
        bias = cs * jnp.float32(bias0) + ds
        return x - bias, bias[-1]

    out_re, b_re = run(re, bias0_re)
    out_im, b_im = run(im, bias0_im)
    return out_re, out_im, b_re, b_im


def pulse_blank(re: jax.Array, im: jax.Array, threshold_sigma: float):
    """Zero samples whose envelope exceeds ``threshold_sigma`` times the
    block RMS (impulsive-interference suppression — the feature the
    reference declared and left TODO, frontend.rs:64).

    Returns (re, im, blanked_fraction)."""
    power = re * re + im * im
    rms2 = jnp.mean(power)
    keep = power <= jnp.float32(threshold_sigma**2) * rms2
    keep_f = keep.astype(jnp.float32)
    return re * keep_f, im * keep_f, 1.0 - jnp.mean(keep_f)


def digital_agc(re: jax.Array, im: jax.Array, gain: jax.Array,
                target_rms: float = 1.0, alpha: float = 0.1):
    """Block-wise digital AGC: smooth the gain toward
    target_rms / block_rms (the digital counterpart of the reference's
    hardware enable_agc flag, rtl_sdr.rs config).

    Returns (re, im, new_gain)."""
    rms = jnp.sqrt(jnp.mean(re * re + im * im) + 1e-20)
    desired = jnp.float32(target_rms) / rms
    new_gain = (1.0 - alpha) * gain + alpha * desired
    return re * new_gain, im * new_gain, new_gain


def design_lowpass_fir(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Hamming-windowed-sinc low-pass (cutoff as fraction of Nyquist)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff_norm * n) * cutoff_norm
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def polyphase_decimate(re: jax.Array, im: jax.Array, taps: jax.Array,
                       factor: int):
    """Decimate by ``factor`` with an anti-alias FIR as one matmul.

    taps length must be a multiple of ``factor``. Implementation: the
    decimated output y[k] = sum_t h[t] x[k*M - t] is a matmul between
    [n_out, T] gathered sample frames and the tap vector; frames are
    built by strided reshape of a padded block (static shapes, no
    gather). Returns (re_out, im_out) of length len(x)//factor.
    """
    n_taps = taps.shape[0]
    m = factor
    n_out = re.shape[0] // m

    # frame k covers samples [k*m - n_taps + 1, k*m]; left-pad by n_taps-1
    def frames(x):
        xp = jnp.concatenate([jnp.zeros(n_taps - 1, x.dtype), x])
        # static-shape frame extraction: build [n_out, n_taps] from
        # n_taps shifted strided column views (n_taps is small, 32-128)
        cols = [xp[t:t + n_out * m:m] for t in range(n_taps)]
        return jnp.stack(cols, axis=1)  # [n_out, n_taps], col t = x[k*m+t-(T-1)]

    rev = taps[::-1]  # so that dot(frame, rev) = sum_t h[t] x[k*m - t]
    fre = frames(re)
    fim = frames(im)
    # full f32 (a GPU may run an f32 matmul in TF32)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(fre, rev, precision=hi),
            jnp.matmul(fim, rev, precision=hi))


@functools.partial(
    jax.jit,
    static_argnames=("fs_hz", "alpha", "decimation", "n_taps",
                     "enable_dc", "enable_mix", "blank_sigma",
                     "enable_agc"),
)
def condition_block(
    re: jax.Array,
    im: jax.Array,
    mix_freq_hz: jax.Array,     # f32 scalar: IF to remove (0 = passthrough)
    phase_acc: jax.Array,       # u32 scalar: mixer phase carried across blocks
    bias_re: jax.Array,         # f32 scalar: DC tracker state
    bias_im: jax.Array,
    agc_gain: jax.Array = 1.0,  # f32 scalar: AGC gain carried across blocks
    *,
    fs_hz: float,
    alpha: float = 0.001,
    decimation: int = 1,
    n_taps: int = 64,
    enable_dc: bool = True,
    enable_mix: bool = True,
    blank_sigma: float = 0.0,   # >0 enables pulse blanking
    enable_agc: bool = False,
):
    """Full conditioning chain for one block; returns
    (re, im, new_phase_acc, new_bias_re, new_bias_im, new_agc_gain)."""
    agc_gain = jnp.asarray(agc_gain, jnp.float32)
    if blank_sigma > 0.0:
        re, im, _ = pulse_blank(re, im, blank_sigma)
    if enable_agc:
        re, im, agc_gain = digital_agc(re, im, agc_gain)
    if enable_dc:
        re, im, bias_re, bias_im = dc_offset_scan(re, im, alpha, bias_re, bias_im)
    if enable_mix:
        step = nco.freq_to_step(mix_freq_hz, fs_hz)
        phase = phase_acc + jnp.arange(re.shape[0], dtype=jnp.uint32) * step
        re, im = nco.mix_down(re, im, phase)
        phase_acc = phase_acc + jnp.uint32(re.shape[0]) * step
    if decimation > 1:
        taps = jnp.asarray(design_lowpass_fir(n_taps, 0.8 / decimation))
        re, im = polyphase_decimate(re, im, taps, decimation)
    return re, im, phase_acc, bias_re, bias_im, agc_gain
