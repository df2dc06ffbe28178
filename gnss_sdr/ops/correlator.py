"""Early/Prompt/Late correlator — the tracking hot loop.

Re-design of the reference's per-channel scalar loop
(reference: src/tracking/do_tracking.rs:231-272): per sample, carrier
wipeoff (sin/cos), three code-chip lookups at +/- the early-late spacing,
and six multiply-accumulates. The reference runs this per channel on
rayon threads; here it is one batched op over ``[channels, window]``,
vmapped for the XLA path; the Pallas block step
(ops/pallas/track_step.py) fuses the slice variant over whole blocks.

Shape-static design (SURVEY.md section 7 "hard parts"): the DLL changes
``code_rate``, so true epoch length N_t = round(fs * L / code_rate)
varies per channel per epoch. XLA needs static shapes, so every epoch
reads a fixed window of W >= N_t samples and masks i >= N_t — equivalent
math, static shape.

Carrier phase uses the exact uint32 NCO (ops/nco.py). Code phase within
the epoch is chip_frac + i * chips_per_sample in f32 (error ~1e-4 chips
across a 16k window; the cross-epoch accumulators stay exact, see
receiver/tracking.py).

BOC support: the code table may be stored at ``oversample`` sub-chip
resolution (2 for BOC(1,1) with the subcarrier baked in); chip indices
scale accordingly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import nco


class EplSums(NamedTuple):
    i_e: jax.Array
    q_e: jax.Array
    i_p: jax.Array
    q_p: jax.Array
    i_l: jax.Array
    q_l: jax.Array


def _epl_sums(wre, wim, early, prompt, late) -> EplSums:
    """The six correlator sums in full float32: a GPU may otherwise run
    an f32 dot in TF32 (~3 decimal digits), far from the CPU reference."""
    def dot(a, b):
        return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)

    return EplSums(
        i_e=dot(wre, early), q_e=dot(wim, early),
        i_p=dot(wre, prompt), q_p=dot(wim, prompt),
        i_l=dot(wre, late), q_l=dot(wim, late),
    )


def epl_correlate_one(
    re: jax.Array,            # [W] f32 window samples (I)
    im: jax.Array,            # [W] f32 window samples (Q)
    n_valid: jax.Array,       # i32 scalar, samples in this epoch
    carr_acc: jax.Array,      # u32 scalar, carrier phase at window[0]
    carr_step: jax.Array,     # u32 scalar, carrier cycles/sample (u32 frac)
    chip_int: jax.Array,      # i32 scalar, integer chip index at window[0]
    chip_frac: jax.Array,     # f32 scalar in [0,1), fractional chips
    chips_per_sample: jax.Array,  # f32 scalar, code_rate / fs
    code: jax.Array,          # [L * oversample] f32 +/-1 code samples
    *,
    el_space: float = 0.5,
    oversample: int = 1,
) -> EplSums:
    """Correlate one channel's epoch window against E/P/L replicas."""
    w = re.shape[0]
    n_code = code.shape[0]
    i_f = jnp.arange(w, dtype=jnp.float32)
    mask = jnp.arange(w, dtype=jnp.int32) < n_valid

    # carrier wipeoff: x * e^{-j phi} (reference do_tracking.rs:232-238)
    phase = carr_acc + jnp.arange(w, dtype=jnp.uint32) * carr_step
    wre, wim = nco.mix_down(re, im, phase)
    wre = jnp.where(mask, wre, 0.0)
    wim = jnp.where(mask, wim, 0.0)

    # chip phases (relative to chip_int) and E/P/L code lookups
    # (reference do_tracking.rs:251-263: floor(cp +/- 0.5) mod L)
    cp = chip_frac + i_f * chips_per_sample
    os_f = jnp.float32(oversample)
    base = chip_int * oversample

    def chips_at(offset_chips):
        idx = base + jnp.floor((cp + offset_chips) * os_f).astype(jnp.int32)
        return code[jnp.mod(idx, n_code)]

    early = chips_at(jnp.float32(el_space))
    prompt = chips_at(jnp.float32(0.0))
    late = chips_at(jnp.float32(-el_space))

    return _epl_sums(wre, wim, early, prompt, late)


def epl_correlate_one_shift(
    re: jax.Array,            # [W] f32 window samples (I)
    im: jax.Array,            # [W] f32 window samples (Q)
    n_valid: jax.Array,       # i32 scalar
    carr_acc: jax.Array,      # u32 scalar
    carr_step: jax.Array,     # u32 scalar
    chip_int: jax.Array,      # i32 scalar
    chip_frac: jax.Array,     # f32 scalar
    chips_per_sample: jax.Array,  # f32 scalar
    code: jax.Array,          # [L * oversample] f32
    *,
    shift: int,
    oversample: int = 1,
    interp: bool = False,
) -> EplSums:
    """Single-gather E/P/L correlator (fast path).

    Because the chip index is a monotone ramp, the early replica equals
    the prompt replica advanced by ``shift`` samples, where
    shift = round(el_space / chips_per_sample); the realized spacing is
    shift * chips_per_sample chips (error < 1e-5 chip at practical
    rates). The chip ramp is arithmetic, so extending it by ``shift`` on
    each side costs nothing, and ONE [W+2s] gather + three static
    slices replace the exact path's three [W] gathers — the dominant
    memory op of the tracking hot loop.

    ``interp=True`` samples the replica with linear interpolation
    between adjacent chips (trapezoid transitions) instead of the
    floor/nearest convention (reference do_tracking.rs:274-277). This
    suppresses the sample-grid quantization bias of the code-phase
    observable (~0.05 chip at 8 samples/chip with floor sampling) at
    the cost of a second gather.
    """
    w = re.shape[0]
    n_code = code.shape[0]

    # chip ramp over [-shift, W+shift): index j maps to epoch sample
    # i = j - shift
    j_f = jnp.arange(w + 2 * shift, dtype=jnp.float32) - jnp.float32(shift)
    cp = chip_frac + j_f * chips_per_sample
    x = cp * jnp.float32(oversample)
    base = jnp.floor(x)
    idx = chip_int * oversample + base.astype(jnp.int32)
    chips = code[jnp.mod(idx, n_code)]          # [W+2s], ONE gather
    if interp:
        frac = x - base
        chips_next = code[jnp.mod(idx + 1, n_code)]
        chips = chips + frac * (chips_next - chips)

    mask = jnp.arange(w, dtype=jnp.int32) < n_valid
    phase = carr_acc + jnp.arange(w, dtype=jnp.uint32) * carr_step
    wre, wim = nco.mix_down(re, im, phase)
    wre = jnp.where(mask, wre, 0.0)
    wim = jnp.where(mask, wim, 0.0)

    prompt = chips[shift:shift + w]
    early = chips[2 * shift:2 * shift + w]
    late = chips[0:w]

    return _epl_sums(wre, wim, early, prompt, late)


def epl_correlate_one_slice(
    re: jax.Array,            # [W] f32 window samples (I)
    im: jax.Array,            # [W] f32 window samples (Q)
    n_valid: jax.Array,       # i32 scalar
    carr_acc: jax.Array,      # u32 scalar
    carr_step: jax.Array,     # u32 scalar
    chip_int: jax.Array,      # i32 scalar
    chip_frac: jax.Array,     # f32 scalar
    chips_per_sample: jax.Array,  # f32 scalar
    code3x: jax.Array,        # [>= 2*n0 + W] f32: code SAMPLED at fs
                              # (nominal rate, BOC baked in), tiled
    *,
    shift: int,
    n0: int,                  # nominal samples per code period
    interp: bool = False,
) -> EplSums:
    """Gather-free E/P/L correlator: the block tracking step's reference.

    Replicas come from ONE dynamic slice of a pre-sampled nominal-rate
    code table at the integer-sample shift below the tracked chip phase
    (contiguous reads, no per-sample gather). Quantization: replica
    alignment is within one sample and the code-rate mismatch (<1e-5
    relative) drifts <0.2 samples across an epoch; the u32/chip loop
    STATE stays exact, so the quantization appears only as replica
    wander the loop filters average — standard practice in
    integer-resampling receivers. ``interp=True`` blends each replica
    with its one-sample-later neighbour by the fractional sample of the
    chip phase, which removes that quantization bias.
    """
    w = re.shape[0]

    # replica start: chip phase converted to nominal sample units.
    # FLOOR, not round: the sampled code table is floor-quantized
    # (chip index = floor(phase)), so phases within one sample share a
    # floor-anchored representative; round is half-a-sample inconsistent
    # for half the phase range, and the Pallas block step
    # (ops/pallas/track_step.py) floors the same way
    cp = chip_int.astype(jnp.float32) + chip_frac
    s_f = cp / chips_per_sample
    s_fl = jnp.floor(s_f)
    s_i = s_fl.astype(jnp.int32)
    n0_i = jnp.int32(n0)
    s_i = jnp.where(s_i >= n0_i, s_i - n0_i, s_i)   # wrap into [0, n0)
    s_i = jnp.where(s_i < 0, s_i + n0_i, s_i)

    # one slice covering [s_i - shift, s_i + W + shift): offset by +n0
    # in the tiled table so the start index is always >= 0
    extra = 1 if interp else 0
    base = jax.lax.dynamic_slice(
        code3x, (s_i + n0_i - jnp.int32(shift),), (w + 2 * shift + extra,)
    )
    if interp:
        base = base[:-1] + (s_f - s_fl) * (base[1:] - base[:-1])
    late = jax.lax.dynamic_slice_in_dim(base, 0, w)
    prompt = jax.lax.dynamic_slice_in_dim(base, shift, w)
    early = jax.lax.dynamic_slice_in_dim(base, 2 * shift, w)

    mask = jnp.arange(w, dtype=jnp.int32) < n_valid
    phase = carr_acc + jnp.arange(w, dtype=jnp.uint32) * carr_step
    wre, wim = nco.mix_down(re, im, phase)
    wre = jnp.where(mask, wre, 0.0)
    wim = jnp.where(mask, wim, 0.0)

    return _epl_sums(wre, wim, early, prompt, late)


# Batched over channels: windows [C, W], code rows [C, L*os], scalars [C].
epl_correlate = jax.vmap(
    epl_correlate_one,
    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0),
    out_axes=0,
)


@functools.partial(jax.jit, static_argnames=("el_space", "oversample"))
def epl_correlate_batch(
    re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
    chips_per_sample, codes, el_space: float = 0.5, oversample: int = 1,
) -> EplSums:
    """Jitted convenience wrapper over the vmapped correlator."""
    return jax.vmap(
        functools.partial(
            epl_correlate_one, el_space=el_space, oversample=oversample
        )
    )(re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
      chips_per_sample, codes)
