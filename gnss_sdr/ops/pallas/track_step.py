"""Block tracking step as one Pallas kernel (Triton route, for Hopper).

The block-step contract is that of ``receiver.tracking.track_block``
over one sample window: T sequential epochs for every channel, with the
epoch arithmetic of ``epoch_step`` and the ``slice`` correlator
(ops/correlator.py). The XLA reference runs at least one launch per
sequential epoch, so loop overhead, not arithmetic, bounds it. Here the
whole block is one launch:

  * the grid runs one program per channel; each program carries its
    channel's loop state (u32 carrier/chip accumulators, loop filters,
    lock bookkeeping) in registers through a ``fori_loop`` over the
    block's T epochs;
  * each epoch reads its window by masked, offset loads from the
    device-resident stream (a 500 ms block at 2.046 MHz is 8 MB and
    stays in L2), in power-of-two chunks for wide windows;
  * the E/P/L replicas are offset loads from the channel's row of the
    nominal-rate sampled code table (``make_sampled_code_table``);
  * the six sums reduce once per epoch, then the discriminators and
    loop filters run as scalars (``jnp.arctan`` for the PLL).

The arithmetic mirrors the reference op for op, so integer bookkeeping
(offsets, epoch counts, flags) matches exactly and the correlator sums
differ only by summation order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...receiver import tracking as trk

_U32 = 4294967296.0
_TWO_PI = 6.283185307179586
# ledger fields the kernel carries ([C] each; prn_idx stays outside)
STATE_FIELDS = tuple(f for f in trk.ChannelState._fields if f != "prn_idx")
_BOOL_TELEM = ("processed", "locked", "lost_event")
# warps per program; default_chunk's sizes were measured at this value
NUM_WARPS = 8


def _round_half_even(x):
    """``jnp.round`` for f32 (lax.round has no Triton lowering)."""
    f = jnp.floor(x)
    d = x - f                                   # exact for f32
    odd = (f - 2.0 * jnp.floor(f * 0.5)) != 0.0
    up = (d > 0.5) | ((d == 0.5) & odd)
    return jnp.where(up, f + 1.0, f)


def _freq_to_step(freq, fs_hz: float):
    """ops.nco.freq_to_step, spelled with the kernel's rounding."""
    cyc = freq / jnp.float32(fs_hz)
    frac = cyc - jnp.floor(cyc)
    return _round_half_even(frac * jnp.float32(_U32)).astype(jnp.uint32)


def _kernel(*refs, p: trk.TrackParams, t_epochs: int, buf_len: int,
            chunk: int):
    n_state = len(STATE_FIELDS)
    sre, sim, codes, base_ref = refs[:4]
    st_in = refs[4:4 + n_state]
    st_out = refs[4 + n_state:4 + 2 * n_state]
    tel = dict(zip(trk.EpochTelemetry._fields, refs[4 + 2 * n_state:]))

    c = pl.program_id(0)
    base = base_ref[0]
    n0 = p.samples_per_code_nominal
    w = p.window
    shift = p.el_shift
    n_chunks = -(-w // chunk)
    fs = jnp.float32(p.fs_hz)
    lane = jax.lax.iota(jnp.int32, chunk)

    def epoch(t, carry):
        (active, offset, epochs, lost, carr_freq, carr_acc, carr_err,
         code_rate, chip_int, chip_frac, code_err, lock_ema) = carry
        if p.carrier_aiding:
            code_rate_eff = code_rate + (
                carr_freq - jnp.float32(p.if_freq_hz)
            ) * jnp.float32(p.aiding_scale)
        else:
            code_rate_eff = code_rate
        n_t = _round_half_even(
            fs * jnp.float32(p.code_length)
            / jnp.maximum(code_rate_eff, 1.0)).astype(jnp.int32)
        can = (active != 0) & (offset >= 0) & (offset + w <= buf_len)

        carr_step = _freq_to_step(carr_freq, p.fs_hz)
        cps = code_rate_eff / fs
        chip_frac_f = chip_frac.astype(jnp.float32) * jnp.float32(1.0 / _U32)
        # replica start in nominal samples (slice correlator: FLOOR)
        s_f = (chip_int.astype(jnp.float32) + chip_frac_f) / cps
        s_fl = jnp.floor(s_f)
        s_i = s_fl.astype(jnp.int32)
        s_i = jnp.where(s_i >= n0, s_i - n0, s_i)
        s_i = jnp.where(s_i < 0, s_i + n0, s_i)
        f_sub = s_f - s_fl
        src = base + offset
        code0 = s_i + n0

        def chunk_body(k, acc):
            i = k * chunk + lane
            m = i < n_t
            start = k * chunk
            x_re = plt.load(sre.at[pl.ds(src + start, chunk)], mask=m,
                            other=0.0)
            x_im = plt.load(sim.at[pl.ds(src + start, chunk)], mask=m,
                            other=0.0)
            ph = carr_acc + i.astype(jnp.uint32) * carr_step
            th = ph.astype(jnp.float32) * jnp.float32(_TWO_PI / _U32)
            co = jnp.cos(th)
            si = jnp.sin(th)
            wre = jnp.where(m, x_re * co + x_im * si, 0.0)
            wim = jnp.where(m, x_im * co - x_re * si, 0.0)

            def rep(lag):
                r0 = plt.load(codes.at[c, pl.ds(code0 + lag + start, chunk)],
                              mask=m, other=0.0)
                if not p.interp_code:
                    return r0
                r1 = plt.load(
                    codes.at[c, pl.ds(code0 + lag + 1 + start, chunk)],
                    mask=m, other=0.0)
                return r0 + f_sub * (r1 - r0)

            early = rep(shift)
            prompt = rep(0)
            late = rep(-shift)
            return (acc[0] + wre * early, acc[1] + wim * early,
                    acc[2] + wre * prompt, acc[3] + wim * prompt,
                    acc[4] + wre * late, acc[5] + wim * late)

        zero = jnp.zeros((chunk,), jnp.float32)
        n_iter = jnp.where(can, jnp.int32(n_chunks), jnp.int32(0))
        accs = jax.lax.fori_loop(jnp.int32(0), n_iter, chunk_body,
                                 (zero,) * 6)
        i_e, q_e, i_p, q_p, i_l, q_l = (jnp.sum(a) for a in accs)

        power = i_p * i_p + q_p * q_p
        if p.lock_mode == "costas":
            nbd = i_p * i_p - q_p * q_p
            metric = nbd / jnp.maximum(power, 1e-12)
            alpha = jnp.float32(0.1)
            new_lock_ema = jnp.where(
                can, (1.0 - alpha) * lock_ema + alpha * metric, lock_ema)
            locked = new_lock_ema > jnp.float32(p.costas_lock_threshold)
        else:
            new_lock_ema = lock_ema
            locked = power > jnp.float32(p.lock_threshold)

        safe_ip = jnp.where(jnp.abs(i_p) < 1e-12, 1e-12, i_p)
        pll_err = jnp.arctan(q_p / safe_ip) * jnp.float32(
            1.0 / (2.0 * 3.141592653589793))
        carr_nco = pll_err * jnp.float32(p.dt / p.pll_tau1) + (
            pll_err - carr_err) * jnp.float32(p.pll_tau2 / p.pll_tau1)
        pow_e = jnp.sqrt(i_e * i_e + q_e * q_e)
        pow_l = jnp.sqrt(i_l * i_l + q_l * q_l)
        el_sum = pow_e + pow_l
        dll_err = jnp.where(
            el_sum > 0.0, (pow_e - pow_l) / jnp.maximum(el_sum, 1e-12), 0.0)
        code_nco = dll_err * jnp.float32(p.dt / p.dll_tau1) + (
            dll_err - code_err) * jnp.float32(p.dll_tau2 / p.dll_tau1)

        upd = can & locked
        n_carr_freq = jnp.where(upd, carr_freq + carr_nco, carr_freq)
        n_carr_err = jnp.where(upd, pll_err, carr_err)
        n_code_rate = jnp.where(upd, code_rate + code_nco, code_rate)
        n_code_err = jnp.where(upd, dll_err, code_err)

        n_t_u = n_t.astype(jnp.uint32)
        n_carr_acc = carr_acc + n_t_u * carr_step
        n_frac = chip_frac + n_t_u * _freq_to_step(code_rate_eff, p.fs_hz)
        n_frac_f = n_frac.astype(jnp.float32) * jnp.float32(1.0 / _U32)
        est_total = chip_frac_f + n_t.astype(jnp.float32) * cps
        carry_c = _round_half_even(est_total - n_frac_f).astype(jnp.int32)
        raw_chip = chip_int + carry_c
        l_i = p.code_length
        n_chip = jnp.where(raw_chip >= l_i, raw_chip - l_i, raw_chip)
        n_chip = jnp.where(n_chip >= l_i, n_chip - l_i, n_chip)

        new_lost = jnp.where(locked, 0, lost + 1)
        lost_event = can & (new_lost >= p.max_lost_epochs)
        survives = can & ~lost_event

        def keep(new, old):
            return jnp.where(survives, new,
                             jnp.where(lost_event, 0.0, old))

        new = (
            jnp.where(lost_event, 0, active),
            jnp.where(can, offset + n_t, offset),
            jnp.where(can, epochs + 1, epochs),
            jnp.where(lost_event, 0, jnp.where(can, new_lost, lost)),
            keep(n_carr_freq, carr_freq),
            jnp.where(can, n_carr_acc, carr_acc),
            keep(n_carr_err, carr_err),
            keep(n_code_rate, code_rate),
            jnp.where(can, n_chip, chip_int),
            jnp.where(can, n_frac, chip_frac),
            keep(n_code_err, code_err),
            jnp.where(lost_event, 0.0, new_lock_ema),
        )
        row = dict(
            processed=can, i_e=i_e, q_e=q_e, i_p=i_p, q_p=q_p, i_l=i_l,
            q_l=q_l, power=power, locked=can & locked,
            lost_event=lost_event, pll_err=pll_err, dll_err=dll_err,
            carr_freq=new[4], code_rate=new[7], start_offset=offset,
            epoch_index=epochs,
            chip_phase=chip_int.astype(jnp.float32) + chip_frac_f,
        )
        for name, ref in tel.items():
            v = row[name]
            ref[t, c] = v.astype(jnp.int32) if name in _BOOL_TELEM else v
        return new

    final = jax.lax.fori_loop(0, t_epochs, epoch,
                              tuple(r[c] for r in st_in))
    for ref, v in zip(st_out, final):
        ref[c] = v


def default_chunk(window: int) -> int:
    """Power-of-two samples per masked load: 512 for windows up to 4096
    samples, 1024 above (fastest of 256/512/1024 at 8 warps on an H100
    for 2.046 MHz GPS and 8.184 MHz E1B), never above the next power of
    two of the window."""
    return min(512 if window <= 4096 else 1024,
               1 << max(0, (window - 1).bit_length()))


@functools.partial(jax.jit, static_argnames=(
    "params", "t_epochs", "buf_len", "interpret"))
def track_block_triton(params: trk.TrackParams, codes, state, stream_re,
                       stream_im, base, *, t_epochs: int, buf_len: int,
                       interpret: bool = False):
    """``trk.track_block(params, codes, state, w_re, w_im, t_epochs)``
    on the window ``stream[base : base + buf_len]``, as one launch.

    Returns (ChannelState, EpochTelemetry [T, C]). Telemetry of epochs a
    channel did not process (``processed`` False) holds zero sums where
    the reference holds sums over a clamped window; consumers mask on
    ``processed`` either way."""
    c = codes.shape[0]
    chunk = default_chunk(params.window)
    ins = [getattr(state, f) for f in STATE_FIELDS]
    ins[0] = ins[0].astype(jnp.int32)                 # active
    state_shapes = [jax.ShapeDtypeStruct((c,), x.dtype) for x in ins]
    telem_dtypes = {
        f: (jnp.int32 if f in _BOOL_TELEM + ("start_offset", "epoch_index")
            else jnp.float32)
        for f in trk.EpochTelemetry._fields}
    telem_shapes = [jax.ShapeDtypeStruct((t_epochs, c), telem_dtypes[f])
                    for f in trk.EpochTelemetry._fields]
    outs = pl.pallas_call(
        functools.partial(_kernel, p=params, t_epochs=t_epochs,
                          buf_len=buf_len, chunk=chunk),
        out_shape=state_shapes + telem_shapes,
        grid=(c,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="track_block_step",
    )(stream_re, stream_im, codes,
      jnp.reshape(base, (1,)).astype(jnp.int32), *ins)
    n = len(STATE_FIELDS)
    st = dict(zip(STATE_FIELDS, outs[:n]))
    st["active"] = st["active"] != 0
    lost = state.active & ~st["active"]
    st["prn_idx"] = jnp.where(lost, -1, state.prn_idx)
    telem = {f: (v != 0 if f in _BOOL_TELEM else v)
             for f, v in zip(trk.EpochTelemetry._fields, outs[n:])}
    return trk.ChannelState(**st), trk.EpochTelemetry(**telem)
