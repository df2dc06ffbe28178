"""Receiver-side driver of the block tracking step (correlator='fused').

The step runs T sequential epochs for every channel over one sample
window with the epoch arithmetic of ``tracking.track_block``; it runs
as one Pallas kernel on the GPU and interpreted on the CPU. The driver
chains blocks ON DEVICE: a ``lax.scan`` over a span of blocks applies
the per-block ledger rules below, so the host syncs once per span and
the exact ledger (u32 carrier/chip accumulators) never leaves the
device inside a span.

  stream [history | n_blocks * block] --scan over blocks-->
      walk + eligibility -> block step on window b -> rebase
  -> ChannelState + per-block EpochTelemetry (one device_get)

Ledger rules between blocks (the step itself runs T epochs):

  * offset walk: with T epochs per block a channel's offset moves by
    its accumulated drift every block. When it falls below the window
    (negative offset) the channel skips forward whole code periods;
    code phase is periodic, and each skipped period is counted in the
    epoch base, because it advances signal time (20 ms bit grid,
    pseudorange by one code period each).
  * late handoffs: a channel whose offset leaves no room for T full
    epochs in the window is deferred one block (state untouched); after
    the rebase it fits. The scanned XLA path instead runs partial
    epochs — one block of extra cold-start latency is the cost of the
    static T.

A single block (``run_block``) is a one-block span.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..config import TrackConfig
from ..models.constellation import SignalSpec
from ..utils import platform
from . import tracking as trk

# room left for in-block drift of the epoch starts when deciding
# whether T epochs fit (|drift| stays within a few samples per block)
DRIFT_MARGIN = 64
WIRES = ("f32", "slim")
_LEDGER_DTYPES = dict(
    active=bool, prn_idx=np.int32, offset=np.int32, epochs=np.int32,
    lost_count=np.int32, carr_freq=np.float32, carr_acc=np.uint32,
    carr_err=np.float32, code_rate=np.float32, chip_int=np.int32,
    chip_frac_u32=np.uint32, code_err=np.float32, lock_ema=np.float32)


class _SpanHandle(tuple):
    """(led, ys, extra, n_blocks) for the pipelined span API — device
    arrays from an asynchronously dispatched span program."""

    __slots__ = ()

    def __new__(cls, led, ys, extra, n_blocks):
        return tuple.__new__(cls, (led, ys, extra, n_blocks))

    led = property(lambda s: s[0])
    ys = property(lambda s: s[1])
    extra = property(lambda s: s[2])
    n_blocks = property(lambda s: s[3])


def block_step(stream_re, stream_im, codes_rows, state, base, *,
               params: trk.TrackParams, t_epochs: int, buf_len: int):
    """The block-step contract: ``track_block`` of ``t_epochs`` epochs
    on the window ``stream[base : base + buf_len]``."""
    from ..ops.pallas.track_step import track_block_triton

    return track_block_triton(
        params, codes_rows, state, stream_re, stream_im, base,
        t_epochs=t_epochs, buf_len=buf_len,
        interpret=platform.interpret_kernels())


@jax.jit
def _apply_handoffs(led, channels, carr_freqs, offsets, rate):
    """Device-side ``trk.start_channel`` for up to 8 handoff slots
    (-1 = empty)."""
    row = jnp.arange(led.active.shape[0], dtype=jnp.int32)
    for h in range(channels.shape[0]):
        m = row == channels[h]                        # -1 matches none
        led = led._replace(
            active=led.active | m,
            offset=jnp.where(m, offsets[h], led.offset),
            epochs=jnp.where(m, 0, led.epochs),
            lost_count=jnp.where(m, 0, led.lost_count),
            carr_freq=jnp.where(m, carr_freqs[h], led.carr_freq),
            carr_acc=jnp.where(m, jnp.uint32(0), led.carr_acc),
            carr_err=jnp.where(m, 0.0, led.carr_err),
            code_rate=jnp.where(m, rate, led.code_rate),
            chip_int=jnp.where(m, 0, led.chip_int),
            chip_frac_u32=jnp.where(m, jnp.uint32(0), led.chip_frac_u32),
            code_err=jnp.where(m, 0.0, led.code_err),
            lock_ema=jnp.where(m, 1.0, led.lock_ema),   # handoff grace
        )
    return led


class FusedTracker:
    """Per-receiver instance wrapping the jitted span program.

    ``wire`` selects the telemetry download format: "f32" (every
    EpochTelemetry field, bit-exact) or "slim" (prompt I/Q as bf16,
    packed flags, and the diagnostic columns at a stride; ~4x fewer
    bytes).

    The span API (submit_span / collect_span / absorb_led /
    apply_handoffs_device) lets the steady-state receiver chain spans
    on device and download telemetry from a collector thread
    (Receiver.run(span_pipeline=True)).
    """

    def __init__(self, params: trk.TrackParams, cfg: TrackConfig,
                 spec: SignalSpec, fs_hz: float, codes_sampled,
                 t_epochs: int, buf_len: int, mesh=None,
                 wire: str = "f32"):
        if cfg.lock_mode not in ("power", "costas"):
            raise ValueError(
                f"correlator='fused': unknown lock_mode {cfg.lock_mode!r}")
        if wire not in WIRES:
            raise ValueError(f"unknown telemetry wire {wire!r}")
        self.wire = wire
        # diagnostic-column stride for the slim wire: the largest
        # divisor of t_epochs <= 8 (5 ms cadence at 1 ms epochs)
        self.wire_stride = next(
            s for s in (8, 5, 4, 2, 1) if t_epochs % s == 0)
        self.params = params
        self.spec = spec
        self.fs = fs_hz
        self.n0 = params.samples_per_code_nominal
        self.t_epochs = t_epochs
        self.buf_len = buf_len
        self.block_len = t_epochs * self.n0
        # last offset from which T epochs still fit in the window
        self.max_offset = (buf_len - (t_epochs - 1) * self.n0
                           - params.window - DRIFT_MARGIN)
        if self.max_offset < self.n0:
            raise ValueError(
                f"buffer too short for fused tracking: len={buf_len}, "
                f"need >= {buf_len - self.max_offset + self.n0}")
        self.codes_sampled = jnp.asarray(codes_sampled)
        step = functools.partial(block_step, params=params,
                                 t_epochs=t_epochs, buf_len=buf_len)
        if mesh is not None:
            # channel-shard the step over the mesh: each device tracks
            # its own channel rows (zero collectives)
            from .. import parallel as par_mod

            n_ch_axis = dict(zip(mesh.axis_names, mesh.devices.shape)
                             ).get(par_mod.CHANNEL_AXIS, 1)
            if cfg.n_channels % n_ch_axis:
                raise ValueError(
                    f"n_channels={cfg.n_channels} not divisible by the "
                    f"mesh channel axis ({n_ch_axis})")
            step = par_mod.shard_fused_step(mesh, step)
        self._step = step
        self.mesh = mesh
        self._scan_fn = None      # built lazily by submit_span
        # optional extra computation fused into the span program:
        # span_extra(stream_re, stream_im, *extra_args) -> pytree runs
        # INSIDE the span jit (the paced acquisition search — zero
        # extra host round trips); its device_get result lands in
        # last_span_extra after each run_blocks call
        self.span_extra = None
        self.last_span_extra = None

    # ------------------------------------------------------------------
    def run_block(self, state: trk.ChannelState, block_re, block_im,
                  codes_rows) -> tuple[trk.ChannelState,
                                       trk.EpochTelemetry]:
        """One block over the window ``[history | block]``: a one-block
        span whose offsets come back relative to this window (the caller
        rebases, as after ``track_block``)."""
        new_state, telems = self.run_blocks(state, block_re, block_im,
                                            codes_rows, 1, extra=False)
        return (new_state._replace(offset=new_state.offset
                                   + np.int32(self.block_len)),
                telems[0])

    def run_blocks(self, state: trk.ChannelState, stream_re, stream_im,
                   codes_rows, n_blocks: int, extra_args=(),
                   extra: bool = True
                   ) -> tuple[trk.ChannelState, list[trk.EpochTelemetry]]:
        """Process ``n_blocks`` consecutive blocks in ONE device program.

        ``stream_re``/``stream_im`` cover ``[history | n_blocks *
        block]`` samples. Telemetry for all blocks downloads in ONE
        device_get. Block b's telemetry offsets are relative to window b
        (global start advances by one block per b); the returned state's
        offsets are already rebased past the whole span (the caller
        must NOT rebase again). ``extra=False`` leaves ``span_extra``
        out of the program.
        """
        handle = self.submit_span(state, stream_re, stream_im,
                                  codes_rows, n_blocks,
                                  extra_args=extra_args, extra=extra)
        ys, extra, led = jax.device_get(
            (handle.ys, handle.extra, handle.led))
        telems, extra = self.collect_span(handle, fetched=(ys, extra))
        self.last_span_extra = extra
        return self.absorb_led(led), telems

    # ------------------------------------------------------------------
    # Pipelined span API: submit_span dispatches asynchronously and the
    # cross-span ledger can CHAIN ON DEVICE (pass handle.led as the
    # next submit's state) — the host only downloads telemetry
    # (collect_span) and absorbs the ledger when it actually needs it
    # (absorb_led). This is what lets the steady-state receiver overlap
    # span b's download/nav with span b+1's compute.
    # ------------------------------------------------------------------
    @staticmethod
    def _as_ledger(state: trk.ChannelState) -> trk.ChannelState:
        return trk.ChannelState(*(
            jnp.asarray(getattr(state, f), _LEDGER_DTYPES[f])
            for f in trk.ChannelState._fields))

    def submit_span(self, led_or_state, stream_re, stream_im,
                    codes_rows, n_blocks: int, extra_args=(),
                    extra: bool = True):
        """Dispatch one span asynchronously. ``led_or_state`` is a host
        ChannelState or a previous handle's ``led`` (the zero-sync
        chaining path). Returns a handle with device arrays."""
        if self._scan_fn is None:
            self._scan_fn = self._make_scan()
        led_f, ys, extra = self._scan_fn(
            jnp.asarray(stream_re), jnp.asarray(stream_im),
            codes_rows, self._as_ledger(led_or_state), n_blocks,
            extra and self.span_extra is not None, extra_args)
        return _SpanHandle(led=led_f, ys=ys, extra=extra,
                           n_blocks=n_blocks)

    def collect_span(self, handle, fetched=None):
        """Download one span's telemetry (+ in-span search output) and
        build the per-block EpochTelemetry list. Does NOT touch the
        ledger (stays on device for chaining). ``fetched`` supplies
        (ys, extra) already downloaded by the caller."""
        ys, extra = (fetched if fetched is not None
                     else jax.device_get((handle.ys, handle.extra)))
        if isinstance(extra, tuple) and not extra:
            extra = None                  # the span ran no span_extra
        if self.wire == "slim":
            telems = [self._telem_from_wire(tuple(w[b] for w in ys))
                      for b in range(handle.n_blocks)]
        else:
            telems = [trk.EpochTelemetry(*(np.asarray(f[b]) for f in ys))
                      for b in range(handle.n_blocks)]
        return telems, extra

    @staticmethod
    def absorb_led(led) -> trk.ChannelState:
        """Download a device ledger into a host (numpy) ChannelState
        (the end-of-pipeline / checkpoint sync)."""
        return trk.ChannelState(*(np.asarray(x)
                                  for x in jax.device_get(led)))

    def apply_handoffs_device(self, led, channels, carr_freqs, offsets):
        """Start up to len(channels) channels IN the device ledger (the
        pipelined path's start_channel — the next span chains off the
        result without a host sync). The caller keeps the PRN
        bookkeeping host-side."""
        ch = np.full(8, -1, np.int32)
        fr = np.zeros(8, np.float32)
        off = np.zeros(8, np.int32)
        n = min(len(channels), 8)
        ch[:n] = channels[:n]
        fr[:n] = carr_freqs[:n]
        off[:n] = offsets[:n]
        return _apply_handoffs(
            self._as_ledger(led), jnp.asarray(ch), jnp.asarray(fr),
            jnp.asarray(off), jnp.float32(self.spec.code_rate_hz))

    # ------------------------------------------------------------------
    def _pack_wire(self, tel: trk.EpochTelemetry):
        """Device-side slim wire of one block's [T, C] telemetry: prompt
        I/Q (bf16), packed lifecycle flags (int8), epoch start and index
        (int32) and chip phase (f32, pseudorange-critical) per epoch;
        E/L correlators, loop errors and NCO rates at ``wire_stride``
        (diagnostics — their consumers are plots and block-scale
        estimators)."""
        s = self.wire_stride
        iq_p = jnp.stack([tel.i_p, tel.q_p], -1).astype(jnp.bfloat16)
        flags = (tel.processed.astype(jnp.int8)
                 + 2 * tel.locked.astype(jnp.int8)
                 + 4 * tel.lost_event.astype(jnp.int8))
        sub_el = jnp.stack([tel.i_e[::s], tel.q_e[::s], tel.i_l[::s],
                            tel.q_l[::s]], -1).astype(jnp.bfloat16)
        sub_errs = jnp.stack([tel.pll_err[::s], tel.dll_err[::s]],
                             -1).astype(jnp.bfloat16)
        sub_rates = jnp.stack([tel.carr_freq[::s], tel.code_rate[::s]], -1)
        return (iq_p, flags, tel.start_offset, tel.epoch_index,
                tel.chip_phase, sub_el, sub_errs, sub_rates)

    def _telem_from_wire(self, wire_b) -> trk.EpochTelemetry:
        """EpochTelemetry from one block's slim wire (numpy): exact for
        everything the nav/observables path consumes (prompt signs,
        flags, epoch timing, chip phase); E/L, loop errors and rates
        are stride samples repeated across their stride."""
        (iq_p, flags, start_offset, epoch_index, chip_phase, sub_el,
         sub_errs, sub_rates) = wire_b
        t = self.t_epochs
        s = self.wire_stride

        def rep(a):
            return np.repeat(np.asarray(a, np.float32), s, axis=0)[:t]

        i_p = iq_p[:, :, 0].astype(np.float32)
        q_p = iq_p[:, :, 1].astype(np.float32)
        fl = flags.astype(np.int32)
        return trk.EpochTelemetry(
            processed=(fl & 1) > 0,
            i_e=rep(sub_el[:, :, 0]), q_e=rep(sub_el[:, :, 1]),
            i_p=i_p, q_p=q_p,
            i_l=rep(sub_el[:, :, 2]), q_l=rep(sub_el[:, :, 3]),
            power=i_p * i_p + q_p * q_p,
            locked=(fl & 2) > 0, lost_event=(fl & 4) > 0,
            pll_err=rep(sub_errs[:, :, 0]),
            dll_err=rep(sub_errs[:, :, 1]),
            carr_freq=rep(sub_rates[:, :, 0]),
            code_rate=rep(sub_rates[:, :, 1]),
            start_offset=np.asarray(start_offset),
            epoch_index=np.asarray(epoch_index),
            chip_phase=np.asarray(chip_phase),
        )

    # ------------------------------------------------------------------
    def _make_scan(self):
        """jitted (stream, codes, ledger, n_blocks) -> (ledger', ys,
        extra): the span program."""
        n0 = self.n0
        block_len = self.block_len
        max_off = self.max_offset
        step = self._step
        pack = self._pack_wire if self.wire == "slim" else None
        span_extra = self.span_extra

        @functools.partial(jax.jit,
                           static_argnames=("n_blocks", "with_extra"))
        def scan_fn(stream_re, stream_im, codes_rows, led0, n_blocks,
                    with_extra, extra_args=()):
            def body(led, b):
                act = led.active
                # offset walk: skip the whole code periods the window no
                # longer holds, counting them in the epoch base
                skip = jnp.where(act & (led.offset < 0),
                                 (n0 - 1 - led.offset) // n0, 0)
                led = led._replace(offset=led.offset + skip * n0,
                                   epochs=led.epochs + skip)
                # defer channels that cannot fit T epochs this block
                eligible = act & (led.offset <= max_off)
                out, telem = step(stream_re, stream_im, codes_rows,
                                  led._replace(active=eligible),
                                  b * block_len)
                # deferred channels pass through the step untouched,
                # except for the activity mask handed to it
                led_n = out._replace(
                    active=jnp.where(eligible, out.active, act),
                    offset=out.offset - block_len)
                return led_n, (pack(telem) if pack is not None else telem)

            led_f, ys = jax.lax.scan(body, led0,
                                     jnp.arange(n_blocks, dtype=jnp.int32))
            extra = (span_extra(stream_re, stream_im, *extra_args)
                     if with_extra else ())
            return led_f, ys, extra
        return scan_fn
