"""Multi-channel DLL/PLL tracking as a scanned, batched compute graph.

Re-design of the reference's tracking engine
(reference: src/tracking/do_tracking.rs). The reference runs 15
``TrackingChannel`` structs on rayon threads, each doing per-sample scalar
math and re-generating its code replica on the host every millisecond
(do_tracking.rs:165). Here:

  * channel state is a structure-of-arrays pytree ``ChannelState`` [C]
    resident on device; channels are a batch dimension (vmap), never
    threads;
  * time is a ``lax.scan`` over epochs within a sample block — sequential
    in time (loop filters carry), parallel in channels, exactly the
    dependency structure the reference's condvar loop enforces
    dynamically (do_tracking.rs:391-414);
  * code replicas are sampled on device inside the correlator from the
    resident ``[n_prn, L]`` chip table — nothing is regenerated per epoch;
  * data-dependent control flow (lock/lost transitions, lost-channel
    reset, reference do_tracking.rs:183-209) is masked ``jnp.where``
    logic, no host round-trips;
  * cross-epoch phase bookkeeping is exact: uint32 NCO accumulators for
    carrier and code fractional phase (the reference's f32 ``% 2pi`` /
    ``% 1023`` at do_tracking.rs:240-242,265-267 accumulates rounding
    error).

Handoff convention note: at the PCPS peak lag the incoming code period
boundary is aligned, so tracking starts there with code phase 0. (The
reference instead seeds ``code_phase = lag * chips_per_sample`` while
also starting at the lag sample, do_tracking.rs:148-154 — a double
offset; the synthetic-loop tests here validate the aligned convention
end-to-end.)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import TrackConfig
from ..models.constellation import SignalSpec
from ..ops import nco
from ..ops.correlator import (
    epl_correlate_one,
    epl_correlate_one_shift,
    epl_correlate_one_slice,
)

_U32_SCALE = 4294967296.0


class ChannelState(NamedTuple):
    """Per-channel tracking state, all arrays [C].

    Field mapping to the reference's TrackingChannel
    (do_tracking.rs:88-115): offset <-> next_sample_index (block-relative
    here), carr_acc/chip_int/chip_frac_u32 <-> carrier_phase/code_phase,
    carr_freq <-> carrier_freq (includes IF), code_rate <-> code_rate.
    """

    active: jax.Array        # bool
    prn_idx: jax.Array       # i32, row in code table; -1 = idle
    offset: jax.Array        # i32, next sample index rel. to block buffer
    epochs: jax.Array        # i32, epochs processed since channel start
    lost_count: jax.Array    # i32
    carr_freq: jax.Array     # f32 Hz (IF + Doppler)
    carr_acc: jax.Array      # u32 carrier phase (cycle fraction)
    carr_err: jax.Array      # f32, previous PLL discriminator
    code_rate: jax.Array     # f32 chips/s
    chip_int: jax.Array      # i32 integer chip index in [0, L)
    chip_frac_u32: jax.Array  # u32 fractional chip (chip fraction)
    code_err: jax.Array      # f32, previous DLL discriminator
    lock_ema: jax.Array      # f32, smoothed Costas lock metric


class EpochTelemetry(NamedTuple):
    """Per-epoch outputs, arrays [C] (stacked to [T, C] by the scan).

    Superset of the reference's legacy TrackingResult telemetry surface
    (src/tracking/tracking_bk.rs:24-43: all six correlators, errors,
    NCOs) — SURVEY.md section 5 observability requirement.
    """

    processed: jax.Array
    i_e: jax.Array
    q_e: jax.Array
    i_p: jax.Array
    q_p: jax.Array
    i_l: jax.Array
    q_l: jax.Array
    power: jax.Array
    locked: jax.Array
    lost_event: jax.Array
    pll_err: jax.Array
    dll_err: jax.Array
    carr_freq: jax.Array
    code_rate: jax.Array
    start_offset: jax.Array  # sample index (block-relative) of epoch start
    epoch_index: jax.Array   # channel epoch counter at epoch start
    chip_phase: jax.Array    # f32 code phase (chips) at epoch start —
                             # the fractional-chip observable that lifts
                             # pseudoranges from sample-quantized (~150 m)
                             # to tracked precision


def _loop_filter_taus(bw: float, damping: float, gain: float) -> tuple[float, float]:
    """2nd-order loop filter time constants (reference do_tracking.rs:60-65)."""
    w = bw * 8.0 * damping / (4.0 * damping * damping + 1.0)
    return gain / (w * w), 2.0 * damping / w


@dataclasses.dataclass(frozen=True)
class TrackParams:
    """Static (trace-time) tracking parameters; hashable for jit."""

    fs_hz: float
    code_length: int
    oversample: int          # code table sub-chip resolution (BOC)
    window: int              # static epoch window W >= max N_t
    nominal_code_rate: float
    el_space: float
    lock_threshold: float
    max_lost_epochs: int
    pll_tau1: float
    pll_tau2: float
    dll_tau1: float
    dll_tau2: float
    dt: float
    correlator: str = "shift"
    el_shift: int = 1
    interp_code: bool = False
    lock_mode: str = "power"
    costas_lock_threshold: float = 0.4
    carrier_aiding: bool = False
    aiding_scale: float = 0.0     # code_rate / RF carrier frequency
    if_freq_hz: float = 0.0       # IF carried in carr_freq (aiding ref)

    @classmethod
    def create(cls, cfg: TrackConfig, spec: SignalSpec, fs_hz: float,
               if_freq_hz: float = 0.0) -> "TrackParams":
        pll_tau1, pll_tau2 = _loop_filter_taus(
            cfg.pll_bandwidth_hz, cfg.pll_damping, cfg.pll_gain
        )
        dll_tau1, dll_tau2 = _loop_filter_taus(
            cfg.dll_bandwidth_hz, cfg.dll_damping, cfg.dll_gain
        )
        n0 = spec.samples_per_code(fs_hz)
        el_chips = cfg.early_late_chips
        if spec.boc_cycles_per_chip:
            # BOC(n,n) ACF: main peak at 0, -0.5 sidelobes at +-0.5/n
            # chip. With the BPSK-default +-0.5-chip E/L offsets the
            # envelope discriminator has STABLE false zeros at
            # +-0.25/n chip (E and L land on equal-magnitude lobe
            # flanks): measured on E1B, the DLL parks exactly one
            # sample (0.25 chip) off, the prompt sits at 0.25x
            # amplitude, and noise swings it onto the -0.5 sidelobe
            # (2x-amplitude sign-flipped symbols, ~0.7% SER). Keep the
            # E/L pair inside the main lobe instead.
            el_chips = min(el_chips, 0.25 / spec.boc_cycles_per_chip)
        return cls(
            fs_hz=fs_hz,
            code_length=spec.code_length_chips,
            oversample=max(1, 2 * spec.boc_cycles_per_chip),
            window=n0 + cfg.window_margin,
            nominal_code_rate=spec.code_rate_hz,
            el_space=el_chips,
            lock_threshold=cfg.lock_threshold,
            max_lost_epochs=cfg.max_lost_epochs,
            pll_tau1=pll_tau1,
            pll_tau2=pll_tau2,
            dll_tau1=dll_tau1,
            dll_tau2=dll_tau2,
            dt=cfg.integration_s * spec.code_period_ms,
            correlator=cfg.correlator,
            el_shift=max(
                1,
                int(round(el_chips * fs_hz / spec.code_rate_hz)),
            ),
            interp_code=cfg.interp_code,
            lock_mode=cfg.lock_mode,
            costas_lock_threshold=cfg.costas_lock_threshold,
            carrier_aiding=cfg.carrier_aiding,
            aiding_scale=spec.code_rate_hz / spec.carrier_freq_hz,
            if_freq_hz=if_freq_hz,
        )

    @property
    def samples_per_code_nominal(self) -> int:
        return int(round(self.fs_hz * self.code_length / self.nominal_code_rate))


def make_sampled_code_table(
    spec: SignalSpec, fs_hz: float, n_prn: int | None = None,
    window: int | None = None,
) -> jax.Array:
    """[P, 2*n0 + W + margin] nominal-rate sampled replicas (BOC baked
    in), tiled so any one-period slice plus E/L margin is contiguous —
    the table for the gather-free 'slice' correlator."""
    import numpy as np

    n0 = spec.samples_per_code(fs_hz)
    w = window or (n0 + 64)
    # the slice correlator and the block step read up to index
    # 2*n0 - 1 + el_shift + W (+1 with code interpolation); a table too
    # short for that makes the slice clamp silently for code phases in
    # the last samples of the period — a misaligned replica for the
    # whole epoch (observed as a power collapse at the period wrap)
    need = 2 * n0 + w + 64
    reps = int(np.ceil(need / n0)) + 1
    rows = []
    for p in range(1, (n_prn or spec.n_prn) + 1):
        one = spec.sample_code(p, spec.code_rate_hz, fs_hz).astype(np.float32)
        rows.append(np.tile(one, reps)[:need])
    return jnp.asarray(np.stack(rows))


def make_code_table(spec: SignalSpec, n_prn: int | None = None) -> jax.Array:
    """Device-resident ``[n_prn, L*oversample]`` f32 replica table.

    For BOC signals the subcarrier is baked in at half-chip resolution so
    the correlator's one gather covers code x subcarrier.
    """
    import numpy as np

    table = spec.code_table()[: (n_prn or spec.n_prn)].astype(np.float32)
    if spec.boc_cycles_per_chip:
        os = 2 * spec.boc_cycles_per_chip
        # repeat each chip os times, multiply by alternating subcarrier
        rep = np.repeat(table, os, axis=1)
        sub = np.tile(
            np.repeat([1.0, -1.0], 1), rep.shape[1] // 2
        ).astype(np.float32)
        rep *= sub[None, :]
        return jnp.asarray(rep)
    return jnp.asarray(table)


def init_state(n_channels: int) -> ChannelState:
    z_f = jnp.zeros(n_channels, jnp.float32)
    z_i = jnp.zeros(n_channels, jnp.int32)
    z_u = jnp.zeros(n_channels, jnp.uint32)
    return ChannelState(
        active=jnp.zeros(n_channels, bool),
        prn_idx=jnp.full(n_channels, -1, jnp.int32),
        offset=z_i, epochs=z_i, lost_count=z_i,
        carr_freq=z_f, carr_acc=z_u, carr_err=z_f,
        code_rate=z_f, chip_int=z_i, chip_frac_u32=z_u, code_err=z_f,
        lock_ema=z_f,
    )


def start_channel(
    state: ChannelState,
    channel: int,
    prn_idx: int,
    carrier_freq_hz: float,
    offset: int,
    code_rate_hz: float,
) -> ChannelState:
    """Functional handoff of an acquisition result into a channel slot
    (replaces the reference's crossbeam message + TrackingChannel::start,
    do_tracking.rs:148-154,351-361)."""
    c = channel
    return state._replace(
        active=state.active.at[c].set(True),
        prn_idx=state.prn_idx.at[c].set(prn_idx),
        offset=state.offset.at[c].set(offset),
        epochs=state.epochs.at[c].set(0),
        lost_count=state.lost_count.at[c].set(0),
        carr_freq=state.carr_freq.at[c].set(carrier_freq_hz),
        carr_acc=state.carr_acc.at[c].set(0),
        carr_err=state.carr_err.at[c].set(0.0),
        code_rate=state.code_rate.at[c].set(code_rate_hz),
        chip_int=state.chip_int.at[c].set(0),
        chip_frac_u32=state.chip_frac_u32.at[c].set(0),
        code_err=state.code_err.at[c].set(0.0),
        # handoff grace: assume locked until the EMA says otherwise
        lock_ema=state.lock_ema.at[c].set(1.0),
    )


def epoch_step(
    params: TrackParams,
    codes: jax.Array,          # [C, L*os] per-channel replica rows
    state: ChannelState,
    block_re: jax.Array,       # [B] f32
    block_im: jax.Array,       # [B] f32
    valid_len: jax.Array | None = None,  # i32 scalar: valid samples in block
) -> tuple[ChannelState, EpochTelemetry]:
    """One tracking epoch for all channels (masked where impossible)."""
    p = params
    block_len = block_re.shape[0]
    limit = (
        jnp.int32(block_len) if valid_len is None
        else jnp.minimum(jnp.int32(block_len), valid_len)
    )
    fs = jnp.float32(p.fs_hz)

    # carrier-aided effective code rate: Doppler scales chip rate by
    # code_rate/carrier (standard practice; absent from the reference)
    if p.carrier_aiding:
        doppler = state.carr_freq - jnp.float32(p.if_freq_hz)
        code_rate_eff = state.code_rate + doppler * jnp.float32(p.aiding_scale)
    else:
        code_rate_eff = state.code_rate

    # true epoch length from current code rate
    # (reference do_tracking.rs:192-193)
    n_t = jnp.round(
        fs * jnp.float32(p.code_length)
        / jnp.maximum(code_rate_eff, 1.0)
    ).astype(jnp.int32)
    # the FULL static window must fit (not just n_t samples): a clipped
    # dynamic_slice would silently misalign the window against the
    # phase/chip origin; deferred epochs are recovered by the +1
    # catch-up step of the next block (track_block docstring)
    can = (
        state.active
        & (state.offset >= 0)
        & (state.offset + p.window <= limit)
    )

    start = jnp.clip(state.offset, 0, block_len - p.window)

    def slice_one(s):
        return (
            jax.lax.dynamic_slice(block_re, (s,), (p.window,)),
            jax.lax.dynamic_slice(block_im, (s,), (p.window,)),
        )

    win_re, win_im = jax.vmap(slice_one)(start)

    carr_step = nco.freq_to_step(state.carr_freq, p.fs_hz)
    chips_per_sample = code_rate_eff / fs
    chip_frac_f = state.chip_frac_u32.astype(jnp.float32) * jnp.float32(
        1.0 / _U32_SCALE
    )

    if p.correlator in ("slice", "fused"):
        sums = jax.vmap(
            functools.partial(
                epl_correlate_one_slice, shift=p.el_shift,
                n0=p.samples_per_code_nominal, interp=p.interp_code,
            )
        )(
            win_re, win_im, n_t, state.carr_acc, carr_step,
            state.chip_int, chip_frac_f, chips_per_sample, codes,
        )
    else:
        if p.correlator == "shift":
            corr_fn = functools.partial(
                epl_correlate_one_shift, shift=p.el_shift,
                oversample=p.oversample, interp=p.interp_code,
            )
        else:
            corr_fn = functools.partial(
                epl_correlate_one, el_space=p.el_space,
                oversample=p.oversample,
            )
        sums = jax.vmap(corr_fn)(
            win_re, win_im, n_t, state.carr_acc, carr_step,
            state.chip_int, chip_frac_f, chips_per_sample, codes,
        )

    power = sums.i_p * sums.i_p + sums.q_p * sums.q_p
    if p.lock_mode == "costas":
        # scale-invariant normalized lock metric (I^2-Q^2)/(I^2+Q^2),
        # EMA-smoothed: instantaneous values on noise are ~uniform in
        # [-1,1] and would flicker past any threshold
        nbd = sums.i_p * sums.i_p - sums.q_p * sums.q_p
        metric = nbd / jnp.maximum(power, 1e-12)
        alpha = jnp.float32(0.1)
        new_lock_ema = jnp.where(
            can, (1.0 - alpha) * state.lock_ema + alpha * metric,
            state.lock_ema,
        )
        locked = new_lock_ema > jnp.float32(p.costas_lock_threshold)
    else:
        new_lock_ema = state.lock_ema
        locked = power > jnp.float32(p.lock_threshold)

    # ---- PLL (Costas atan discriminator, reference do_tracking.rs:280-286)
    safe_ip = jnp.where(jnp.abs(sums.i_p) < 1e-12, 1e-12, sums.i_p)
    pll_err = jnp.arctan(sums.q_p / safe_ip) * jnp.float32(
        1.0 / (2.0 * jnp.pi)
    )
    carr_nco = pll_err * jnp.float32(p.dt / p.pll_tau1) + (
        pll_err - state.carr_err
    ) * jnp.float32(p.pll_tau2 / p.pll_tau1)
    new_carr_freq = state.carr_freq + carr_nco

    # ---- DLL (normalized early-late envelope, do_tracking.rs:288-301)
    pow_e = jnp.sqrt(sums.i_e * sums.i_e + sums.q_e * sums.q_e)
    pow_l = jnp.sqrt(sums.i_l * sums.i_l + sums.q_l * sums.q_l)
    el_sum = pow_e + pow_l
    dll_err = jnp.where(el_sum > 0.0, (pow_e - pow_l) / jnp.maximum(el_sum, 1e-12), 0.0)
    code_nco = dll_err * jnp.float32(p.dt / p.dll_tau1) + (
        dll_err - state.code_err
    ) * jnp.float32(p.dll_tau2 / p.dll_tau1)
    new_code_rate = state.code_rate + code_nco

    # loop filters engage only on locked epochs (do_tracking.rs:188-191)
    upd_loops = can & locked
    new_carr_freq = jnp.where(upd_loops, new_carr_freq, state.carr_freq)
    new_carr_err = jnp.where(upd_loops, pll_err, state.carr_err)
    new_code_rate = jnp.where(upd_loops, new_code_rate, state.code_rate)
    new_code_err = jnp.where(upd_loops, dll_err, state.code_err)

    # ---- exact phase advance over n_t samples (every processed epoch)
    new_carr_acc = nco.advance(state.carr_acc, carr_step, n_t)
    code_step_u32 = nco.freq_to_step(code_rate_eff, p.fs_hz)  # frac chips
    new_frac_u32 = state.chip_frac_u32 + n_t.astype(jnp.uint32) * code_step_u32
    new_frac_f = new_frac_u32.astype(jnp.float32) * jnp.float32(1.0 / _U32_SCALE)
    est_total = chip_frac_f + n_t.astype(jnp.float32) * chips_per_sample
    carry = jnp.round(est_total - new_frac_f).astype(jnp.int32)
    # select-wrap (chip_int + carry < 2L always): the same arithmetic
    # as the Pallas block step, which has no integer mod
    raw_chip = state.chip_int + carry
    l_i = jnp.int32(p.code_length)
    new_chip_int = jnp.where(raw_chip >= l_i, raw_chip - l_i, raw_chip)
    new_chip_int = jnp.where(new_chip_int >= l_i, new_chip_int - l_i,
                             new_chip_int)

    # ---- lock / lost bookkeeping (do_tracking.rs:183-209)
    new_lost = jnp.where(locked, 0, state.lost_count + 1)
    lost_event = can & (new_lost >= p.max_lost_epochs)

    def sel(new, old):
        return jnp.where(can, new, old)

    survives = can & ~lost_event
    new_state = ChannelState(
        active=jnp.where(lost_event, False, state.active),
        prn_idx=jnp.where(lost_event, -1, state.prn_idx),
        offset=sel(state.offset + n_t, state.offset),
        epochs=sel(state.epochs + 1, state.epochs),
        lost_count=jnp.where(
            lost_event, 0, jnp.where(can, new_lost, state.lost_count)
        ),
        carr_freq=jnp.where(survives, new_carr_freq, jnp.where(lost_event, 0.0, state.carr_freq)),
        carr_acc=jnp.where(can, new_carr_acc, state.carr_acc),
        carr_err=jnp.where(survives, new_carr_err, jnp.where(lost_event, 0.0, state.carr_err)),
        code_rate=jnp.where(survives, new_code_rate, jnp.where(lost_event, 0.0, state.code_rate)),
        chip_int=jnp.where(can, new_chip_int, state.chip_int),
        chip_frac_u32=jnp.where(can, new_frac_u32, state.chip_frac_u32),
        code_err=jnp.where(survives, new_code_err, jnp.where(lost_event, 0.0, state.code_err)),
        lock_ema=jnp.where(lost_event, 0.0, new_lock_ema),
    )

    chip_phase_start = (
        state.chip_int.astype(jnp.float32) + chip_frac_f
    )
    telem = EpochTelemetry(
        processed=can,
        i_e=sums.i_e, q_e=sums.q_e, i_p=sums.i_p, q_p=sums.q_p,
        i_l=sums.i_l, q_l=sums.q_l,
        power=power, locked=can & locked, lost_event=lost_event,
        pll_err=pll_err, dll_err=dll_err,
        carr_freq=new_state.carr_freq, code_rate=new_state.code_rate,
        start_offset=state.offset, epoch_index=state.epochs,
        chip_phase=chip_phase_start,
    )
    return new_state, telem


@functools.partial(jax.jit, static_argnames=("params", "n_epochs"))
def track_block(
    params: TrackParams,
    codes: jax.Array,
    state: ChannelState,
    block_re: jax.Array,
    block_im: jax.Array,
    n_epochs: int,
    valid_len: jax.Array | None = None,
) -> tuple[ChannelState, EpochTelemetry]:
    """Run ``n_epochs`` tracking epochs over one resident sample block.

    Returns the carried state and [T, C] telemetry. The caller picks
    ``n_epochs = block_ms / code_period_ms + 1`` — the +1 lets channels
    that fell behind catch up one epoch per block (self-healing against
    per-channel epoch-length drift). ``valid_len`` bounds processing when
    the block's tail is zero padding (short final read).
    """

    def body(st, _):
        return epoch_step(params, codes, st, block_re, block_im, valid_len)

    return jax.lax.scan(body, state, None, length=n_epochs)


def rebase(state: ChannelState, advance: int) -> ChannelState:
    """Shift block-relative offsets after the host rolls the sample window
    forward by ``advance`` samples (replaces the reference's absolute
    multicast-ring indices, multicast_ring_buffer.rs:103-105)."""
    return state._replace(offset=state.offset - advance)
