"""The receiver: streaming orchestration of acquisition + tracking.

Replacement for the reference's four-thread pipeline
(reference: src/main.rs:167-230 — sdr/rf/acq/trk threads over ring
buffers and crossbeam channels; note SURVEY.md section 3.1: the
reference's main() joins each thread immediately and thus never actually
runs concurrently — this implements the *intended* design). Here the
host loop is simple and sequential; all concurrency lives inside the
batched device graphs:

  per block:  advance window -> (paced) PCPS search + handoff ->
              track_block scan -> rebase -> telemetry/lifecycle

Channel lifecycle (Idle -> Tracking -> Lost -> re-search) replaces the
crossbeam SatelliteLocked/SatelliteLost message protocol
(do_tracking.rs:47-50, do_acquisition.rs:278-287) with pure-functional
state transitions plus a host-side PRN<->channel map.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ReceiverConfig
from ..models.constellation import get_signal
from ..utils.profiling import StageTimer
from ..utils.telemetry import TelemetryLog
from . import tracking as trk
from .acquisition import AcquisitionEngine, SearchScheduler
from .navproc import NavProcessor
from .stream import DeviceStreamWindow, SampleSource, StreamWindow


class Receiver:
    def __init__(self, cfg: ReceiverConfig, source: SampleSource):
        self.cfg = cfg
        self.source = source
        self.spec = get_signal(cfg.acq.signal)
        # multi-MB host temporaries every block: keep them on a warm
        # heap (utils/host.py — demand-paged VMs fault ~200x otherwise)
        from ..utils.host import tune_host_allocator

        tune_host_allocator()
        # persistent compile cache for GPU programs (utils/platform.py:
        # $JAX_COMPILATION_CACHE_DIR, else a fixed in-checkout path)
        from ..utils import platform

        platform.enable_compile_cache()

        # Digital front end (reference L2): mixes out the IF and/or
        # decimates before the window, so everything downstream runs at
        # baseband and the (lower) output rate.
        self.fs_in = float(source.fs_hz)
        stream_if = float(cfg.f_if_hz)
        self.decim = max(1, cfg.rf.decimation)
        self.mix = cfg.rf.enable_mixing and stream_if != 0.0
        self.dc = cfg.rf.enable_dc_removal
        self.blank_sigma = cfg.rf.pulse_blank_sigma
        self.agc = cfg.rf.enable_digital_agc
        self.conditioning = (
            self.mix or self.dc or self.decim > 1
            or self.blank_sigma > 0 or self.agc
        )
        self.mix_freq = stream_if if self.mix else 0.0
        self.fs = self.fs_in / self.decim
        # the configured output rate must agree with the derived rate —
        # downstream timing (code epochs, pseudoranges) uses the derived
        # one, so a silent mismatch would corrupt every observable
        if abs(cfg.rf.output_sample_rate_hz - self.fs) > 1e-6 * self.fs:
            raise ValueError(
                f"rf.output_sample_rate_hz={cfg.rf.output_sample_rate_hz:g}"
                f" != source fs / decimation = {self.fs_in:g}/{self.decim}"
                f" = {self.fs:g}"
            )
        self.f_if = 0.0 if self.mix else stream_if
        self._fe_phase = np.uint32(0)
        self._fe_bias_re = np.float32(0.0)
        self._fe_bias_im = np.float32(0.0)
        self._fe_agc_gain = np.float32(1.0)

        n0 = self.spec.samples_per_code(self.fs)
        self.n0 = n0
        period = self.spec.code_period_ms
        if cfg.block_ms % period:
            raise ValueError(
                f"block_ms={cfg.block_ms} must be a multiple of the "
                f"code period ({period} ms)"
            )
        self.epochs_per_block = cfg.block_ms // period
        self.block = self.epochs_per_block * n0
        if self.spec.name.startswith("galileo_e1"):
            from ..models.codes import galileo_e1 as _gal

            comp = "E1B" if self.spec.name.endswith("b") else "E1C"
            if _gal.using_surrogate_codes(comp):
                import warnings

                warnings.warn(
                    f"signal={self.spec.name!r} is running on SURROGATE "
                    "Galileo E1 codes (the ICD memory codes are data, not "
                    "generatable); real-sky captures will acquire nothing. "
                    "Load the ICD hex tables via "
                    "models.codes.galileo_e1.load_codes_hex().",
                    stacklevel=2,
                )
        self.engine = AcquisitionEngine(cfg.acq, self.spec, self.fs,
                                        self.f_if)
        acq_len = self.engine.samples_needed  # +1 period on linear paths
        self.acq_len = acq_len
        # history: the acquisition chunk plus tracking window slack must
        # stay addressable behind the frontier
        self.history = acq_len + 2 * n0

        self.params = trk.TrackParams.create(
            cfg.track, self.spec, self.fs, if_freq_hz=self.f_if
        )

        # optional device mesh: tracking channels shard as a data-
        # parallel axis (zero steady-state collectives); see
        # gnss_sdr.parallel for the ops-level sharded entry points
        self.mesh = None
        par = cfg.parallel
        if par.channel_axis > 1 or par.time_axis > 1:
            from .. import parallel as par_mod

            if cfg.track.n_channels % par.channel_axis:
                raise ValueError(
                    f"n_channels={cfg.track.n_channels} not divisible by "
                    f"parallel.channel_axis={par.channel_axis}"
                )
            self.mesh = par_mod.make_mesh(
                n_time=par.time_axis, n_channel=par.channel_axis
            )
        if cfg.track.correlator in ("slice", "fused"):
            self.codes_full = trk.make_sampled_code_table(
                self.spec, self.fs, cfg.acq.n_prn,
                window=self.params.window,
            )
        else:
            self.codes_full = trk.make_code_table(self.spec, cfg.acq.n_prn)
        self.state = trk.init_state(cfg.track.n_channels)
        # device-resident window on the GPU: upload only the fresh block
        # per step and slice acquisition chunks / tracking windows
        # on-device; the CPU keeps the host window
        on_cpu = platform.backend() == "cpu"
        if on_cpu:
            self.window = StreamWindow(self.history, self.block)
        else:
            self.window = DeviceStreamWindow(self.history, self.block)
        self.fused = None
        if cfg.track.correlator == "fused":
            from .fused_runner import FusedTracker

            # a mesh channel-shards the block step (shard_fused_step:
            # each device tracks its own channel rows, zero collectives)
            wire = cfg.track.telemetry_wire
            if wire == "auto":
                # CPU keeps the bit-exact f32 wire (test/parity format)
                wire = "f32" if on_cpu else "slim"
            self.fused = FusedTracker(
                self.params, cfg.track, self.spec, self.fs,
                self.codes_full, self.epochs_per_block,
                self.history + self.block, mesh=self.mesh, wire=wire,
            )
        self.engine = AcquisitionEngine(cfg.acq, self.spec, self.fs, self.f_if)
        self.scheduler = SearchScheduler(cfg.acq)
        # in-scan acquisition: the conv engine's search embeds INSIDE
        # the steady-state span program (FusedTracker.span_extra), so
        # the paced re-search costs zero extra host round trips — its
        # candidate arrays ride the span download (_process_span).
        self._span_acq = False
        if (self.fused is not None and self.engine.engine == "conv"
                # FDMA searches per-channel grid shifts and two_peak/
                # cfar use different threshold statistics — those
                # configs keep the (equivalent-sensitivity) boundary
                # search instead of the in-scan fast path
                and not cfg.acq.fdma_spacing_hz
                and cfg.acq.detector == "peak_avg"):
            _eng = self.engine
            _n = self.acq_len

            def _span_search(sre, sim, sel):
                # the steady re-search uses the 8-row candidate bucket
                # (stable shape, ~4x less work than the full
                # constellation); sel/rowmap are built at submit time
                return _eng.conv_search_device(sre[-_n:], sim[-_n:],
                                               sel)

            self.fused.span_extra = _span_search
            self._span_acq = True
        self.telemetry = TelemetryLog(cfg.track.n_channels)
        self.nav = NavProcessor(
            self.fs, self.spec.code_period_s, self.spec.code_length_chips,
            signal=self.spec.name,
        )
        self.active: dict[int, int] = {}   # prn -> channel
        self._codes_key = None
        self._codes_ch = None
        self._pipeline_handoffs: list = []
        self._pipeline_active_mask = None
        self._span_rowmap = None
        self.time_ms = 0.0
        self.acq_events: list = []
        self.timers = StageTimer()
        # streaming outputs (enable_observables)
        self._obs_writer = None
        self._obs_every_ms = 0
        self._obs_last_ms = 0.0
        self._obs_last_update_ms = None
        self._obs_week = 0
        self.nav_filter = None

    # ------------------------------------------------------------------
    def _run_acquisition(self) -> None:
        w0 = self.history + self.block - self.acq_len
        chunk = (self.window.re[w0:], self.window.im[w0:])
        allowed = set(self.scheduler.candidates(set(self.active)))
        if not allowed:
            return
        cands = self.engine.search(chunk, window_offset=w0, allowed_prns=allowed)
        self.scheduler.mark_run(self.time_ms)
        self._handoff(cands)

    def _handoff(self, cands) -> None:
        """Hand acquisition candidates to idle tracking channels."""
        if not cands:
            return
        # state leaves are numpy-backed after a fused span/block (the
        # runner absorbs host-side); start_channel's .at updates need
        # jax arrays — [C]-sized, so the round trip is noise
        self.state = jax.tree.map(jnp.asarray, self.state)
        for cand in cands:
            if cand.prn in self.active:
                continue
            idle = np.where(~np.asarray(self.state.active))[0]
            if idle.size == 0:
                break  # no free channel (reference drops the result too,
                # do_tracking.rs:351-361 finds no Idle channel)
            ch = int(idle[0])
            self.state = trk.start_channel(
                self.state, ch, cand.prn - 1, cand.carrier_freq_hz,
                cand.sample_local_index, self.spec.code_rate_hz,
            )
            self.active[cand.prn] = ch
            self.telemetry.open_channel(ch, cand.prn)
            self.nav.open_channel(ch, cand.prn)
            self.acq_events.append((self.time_ms, cand))

    # ------------------------------------------------------------------
    def _pull_block(self):
        """Read one raw block and run the front-end conditioning chain."""
        from ..ops.frontend import condition_block

        need = self.block * self.decim
        raw = self.source.read(need)
        if raw is None:
            return None
        if isinstance(raw, tuple):
            # planar source (possibly device-resident — zero staging)
            re, im = raw
            size = int(re.shape[0])
            if size == 0:
                return None
            if size < need:
                pad = need - size
                if isinstance(re, np.ndarray):
                    re = np.pad(re, (0, pad))
                    im = np.pad(im, (0, pad))
                else:
                    import jax.numpy as jnp

                    re = jnp.pad(re, (0, pad))
                    im = jnp.pad(im, (0, pad))
        else:
            if raw.size == 0:
                return None
            size = raw.size
            if size < need:
                raw = np.pad(raw, (0, need - size))
            re = np.ascontiguousarray(np.real(raw), dtype=np.float32)
            im = np.ascontiguousarray(np.imag(raw), dtype=np.float32)
        n_valid = -(-size // self.decim)  # valid output samples
        if not self.conditioning:
            return (re, im), n_valid
        (re, im, self._fe_phase, self._fe_bias_re, self._fe_bias_im,
         self._fe_agc_gain) = condition_block(
            re, im, np.float32(self.mix_freq), self._fe_phase,
            self._fe_bias_re, self._fe_bias_im, self._fe_agc_gain,
            fs_hz=self.fs_in, alpha=self.cfg.rf.dc_alpha,
            decimation=self.decim, enable_dc=self.dc,
            enable_mix=self.mix, blank_sigma=self.blank_sigma,
            enable_agc=self.agc,
        )
        # re/im stay whatever condition_block produced (device arrays);
        # both window kinds accept them — no forced host round trip
        return (re, im), n_valid

    def step(self) -> bool:
        """Process one block; returns False at end of stream."""
        with self.timers.stage("ingest", self.block * self.decim):
            pulled = self._pull_block()
            if pulled is None:
                return False
        samples, n_valid = pulled
        return self._process_block(samples, n_valid)

    def _process_block(self, samples, n_valid) -> bool:
        n_fresh = self.window.advance(samples)
        if n_fresh is None:
            return False
        self.time_ms += self.cfg.block_ms

        # paced satellite search over the freshest samples
        self.scheduler.update_mode(len(self.active))
        have_enough = self.window.blocks_fed * self.block >= self.acq_len
        if have_enough and self.scheduler.due(self.time_ms):
            with self.timers.stage("acquire", self.acq_len):
                self._run_acquisition()

        # one scan over the block for all channels (+1 catch-up epoch)
        with self.timers.stage("track", self.block):
            codes_ch = self._codes_for_state()
            re = self.window.re
            im = self.window.im
            if self.fused is not None and n_valid == self.block:
                # block step: T static epochs, ledger rules in
                # receiver/fused_runner.py; partial tail blocks fall
                # through to the scanned path
                self.state, telem = self.fused.run_block(
                    self.state, re, im, codes_ch)
            elif self.mesh is not None:
                from .. import parallel as par_mod

                self.state, telem = par_mod.sharded_track_block(
                    self.mesh, self.params, codes_ch, self.state, re, im,
                    self.epochs_per_block + 1,
                    valid_len=np.int32(self.history + n_valid),
                )
            else:
                self.state, telem = trk.track_block(
                    self.params, codes_ch, self.state, re, im,
                    self.epochs_per_block + 1,
                    valid_len=np.int32(self.history + n_valid),
                )
            # one batched device_get: every downstream consumer
            # (telemetry log, nav processor, lifecycle) is numpy, and
            # fetching the leaves one np.asarray at a time would pay a
            # device sync each
            telem = jax.device_get(telem)

        with self.timers.stage("nav", self.block):
            self.telemetry.append_block(telem, self.window.global_start)
            if self.cfg.pvt.enable:
                self.nav.feed_block(telem, self.window.global_start)

        # lifecycle: channels lost during this block free their PRN
        lost = np.asarray(telem.lost_event).any(axis=0)
        if lost.any():
            for prn, ch in list(self.active.items()):
                if lost[ch]:
                    del self.active[prn]
                    self.telemetry.close_channel(ch)
                    self.nav.close_channel(ch)

        self._emit_observables()
        self.state = trk.rebase(self.state, self.block)
        return True

    # ------------------------------------------------------------------
    def _codes_for_state(self):
        """Per-channel replica rows, cached on channel (re)assignment:
        rebuilding every block costs a device gather per block
        (serialized on some backends)."""
        key = tuple(np.asarray(self.state.prn_idx).tolist())
        if key != self._codes_key:
            self._codes_key = key
            self._codes_ch = self.codes_full[
                jnp.maximum(self.state.prn_idx, 0)]
        return self._codes_ch

    # ------------------------------------------------------------------
    def step_scan(self, k: int) -> int:
        """Process up to ``k`` blocks in ONE device program.

        Uses FusedTracker.run_blocks (the in-graph multi-block scan):
        the host syncs once per span instead of once per block.
        Acquisition never runs inside a span;
        ``run(scan_blocks=...)`` schedules spans strictly between due
        searches. Partial tail blocks fall back to the single-block
        path. Returns the number of blocks processed (0 at
        end-of-stream).
        """
        full, tail = [], None
        for _ in range(k):
            with self.timers.stage("ingest", self.block * self.decim):
                pulled = self._pull_block()
            if pulled is None:
                break
            samples, n_valid = pulled
            if n_valid == self.block:
                full.append(samples)
            else:
                tail = (samples, n_valid)
                break
        done = 0
        if len(full) == k:
            # exactly the requested span: the ONE static shape
            # run_blocks was compiled for. Short reads (end of stream)
            # fall through to the warm single-block path instead of
            # triggering a fresh trace and compile of a new n_blocks
            # inside a timed region.
            done += self._process_span(full)
        else:
            for s in full:
                if self._process_block(s, self.block):
                    done += 1
        if tail is not None and self._process_block(*tail):
            done += 1
        return done

    def _process_span(self, blocks: list) -> int:
        """Run ``len(blocks)`` full fresh blocks through the fused
        multi-block scan; mirrors the per-block bookkeeping of
        _process_block (telemetry, nav, lifecycle) from the one
        downloaded span."""
        k = len(blocks)
        with self.timers.stage("track", self.block * k):
            # window rolls past the whole span (state offsets come back
            # already rebased — no trk.rebase here)
            stream_re, stream_im, g0 = self._advance_span_window(blocks)
            extra_args = ()
            if self._span_acq:
                sel_np, self._span_rowmap = self.engine.steady_sel(
                    self.scheduler.candidates(set(self.active)))
                extra_args = (jnp.asarray(sel_np),)
            self.state, telems = self.fused.run_blocks(
                self.state, stream_re, stream_im,
                self._codes_for_state(), k, extra_args=extra_args)

        with self.timers.stage("nav", self.block * k):
            for b, telem in enumerate(telems):
                gs = g0 + (b + 1) * self.block
                self.telemetry.append_block(telem, gs)
                if self.cfg.pvt.enable:
                    self.nav.feed_block(telem, gs)
                lost = np.asarray(telem.lost_event).any(axis=0)
                if lost.any():
                    for prn, ch in list(self.active.items()):
                        if lost[ch]:
                            del self.active[prn]
                            self.telemetry.close_channel(ch)
                            self.nav.close_channel(ch)
                # per in-span block: observables keep their configured
                # cadence (every_ms) instead of silently degrading to
                # once per span — all the telemetry is already here
                self.time_ms += self.cfg.block_ms
                self._emit_observables()
        # in-scan paced re-search: the span program already computed
        # the full-constellation conv search on the stream tail (the
        # exact chunk the boundary search would use); consume it here
        # so run() never pays a separate search dispatch in steady
        # state. mark_run gates run()'s own fallback via due().
        if self._span_acq and self.fused.last_span_extra is not None:
            have_enough = (self.window.blocks_fed * self.block
                           >= self.acq_len)
            if have_enough and self.scheduler.due(self.time_ms):
                with self.timers.stage("acquire", self.acq_len):
                    allowed = set(self.scheduler.candidates(
                        set(self.active)))
                    if allowed:
                        cands = self.engine.candidates_from_conv(
                            self.fused.last_span_extra,
                            window_offset=(self.history + self.block
                                           - self.acq_len),
                            allowed_prns=allowed,
                            rowmap=self._span_rowmap)
                        self.scheduler.mark_run(self.time_ms)
                        self._handoff(cands)
        self.scheduler.update_mode(len(self.active))
        return k

    # ------------------------------------------------------------------
    def _pipeline_quick(self, extra, rowmap=None):
        """The cheap post-span step that must happen BEFORE the next
        submit: turn the in-scan search output into queued handoffs."""
        if (self._span_acq and extra is not None
                and self.scheduler.due(self.time_ms)):
            allowed = set(self.scheduler.candidates(set(self.active)))
            if allowed:
                cands = self.engine.candidates_from_conv(
                    extra,
                    window_offset=(self.history + self.block
                                   - self.acq_len),
                    allowed_prns=allowed,
                    rowmap=rowmap)
                self.scheduler.mark_run(self.time_ms)
                self._pipeline_handoffs.extend(cands)

    def _collect_pipelined(self, handle, g0, on_block, result=None,
                           skip_quick=False, rowmap=None):
        """Consume one collected span: telemetry, nav, lifecycle,
        observables, and the in-scan search (whose handoffs are QUEUED
        for the next submit — the pipelined path's one-span acquisition
        latency). ``result`` supplies (telems, extra) already fetched
        by the collector thread. Returns (n_blocks, stop_requested)."""
        ft = self.fused
        k = handle.n_blocks
        if result is None:
            with self.timers.stage("track", self.block * k):
                telems, extra = ft.collect_span(handle)
        else:
            telems, extra = result
        with self.timers.stage("nav", self.block * k):
            for b, telem in enumerate(telems):
                gs = g0 + (b + 1) * self.block
                self.telemetry.append_block(telem, gs)
                if self.cfg.pvt.enable:
                    self.nav.feed_block(telem, gs)
                lost = np.asarray(telem.lost_event).any(axis=0)
                if lost.any():
                    for prn, ch in list(self.active.items()):
                        if lost[ch]:
                            del self.active[prn]
                            self.telemetry.close_channel(ch)
                            self.nav.close_channel(ch)
                            if self._pipeline_active_mask is not None:
                                self._pipeline_active_mask[ch] = False
                self.time_ms += self.cfg.block_ms
                self._emit_observables()
        if not skip_quick:
            self._pipeline_quick(extra, rowmap=rowmap)
        self.scheduler.update_mode(len(self.active))
        stop = bool(on_block is not None and on_block(self))
        return k, stop

    def _run_pipelined(self, k: int, budget, on_block):
        """Steady-state span pipeline: spans chain their ledger ON
        DEVICE (FusedTracker.submit_span/handle.led), so span b+1
        dispatches before span b's telemetry download — the download
        and host nav overlap the next span's device compute, and the
        host syncs once per span for TELEMETRY ONLY. Acquisition
        handoffs from the in-scan search apply as device ledger
        updates one span late (documented pipeline latency; cold/warm
        acquisition never runs pipelined). Returns (blocks, eos)."""
        import queue as _q
        import threading

        from .acquisition import SearchMode

        ft = self.fused
        led = self.state                  # first submit absorbs host state
        pending = None                    # (handle, g0) in the collector
        done = 0
        leftovers = []
        eos = False
        stop = False
        self._pipeline_handoffs = []
        self._pipeline_active_mask = np.asarray(self.state.active).copy()
        prn_mirror = np.asarray(self.state.prn_idx).copy()

        # collector thread: ONLY the pure download+reconstruct
        # (FusedTracker.collect_span — jax.device_get + numpy); all
        # receiver-state mutation stays on this thread. The download of
        # span b then overlaps span b+1's device compute AND this
        # thread's ingest/nav work.
        in_q: _q.Queue = _q.Queue(maxsize=1)
        out_q: _q.Queue = _q.Queue(maxsize=1)

        def _collector():
            while True:
                item = in_q.get()
                if item is None:
                    return
                try:
                    out_q.put((ft.collect_span(item), None))
                except Exception as e:  # noqa: BLE001
                    out_q.put((None, e))

        th = threading.Thread(target=_collector, daemon=True)
        th.start()
        import queue as _qmod

        def pop_pending(quick_only: bool = False):
            """Wait for the collector's result. With ``quick_only``
            the heavy nav processing is DEFERRED (returned) so the
            caller can submit the next span first — the nav work then
            overlaps the collector's next download."""
            nonlocal pending, done, stop
            handle, g0, rmap = pending
            with self.timers.stage("track", self.block * handle.n_blocks):
                result, err = out_q.get()
            if err is not None:
                raise err
            pending = None
            if quick_only:
                self._pipeline_quick(result[1], rowmap=rmap)
                return (handle, g0, result)
            n_done, s = self._collect_pipelined(handle, g0, on_block,
                                                result=result,
                                                rowmap=rmap)
            done += n_done
            stop = stop or s
            return None

        try:
            while (not stop
                   and self.scheduler.mode == SearchMode.STEADY
                   and (budget is None
                        or budget - done - (k if pending else 0) >= k)):
                full = []
                for _ in range(k):
                    with self.timers.stage("ingest", self.block * self.decim):
                        pulled = self._pull_block()
                    if pulled is None:
                        eos = True
                        break
                    samples, n_valid = pulled
                    if n_valid == self.block:
                        full.append(samples)
                    else:
                        leftovers.append((samples, n_valid))
                        eos = True
                        break
                if len(full) < k:
                    # not a full span: remaining blocks flush through the
                    # single-block path after the pipeline drains
                    leftovers = [(s, self.block) for s in full] + leftovers
                    break
                # wait for the previous span's results (its download ran in
                # the collector thread while we ingested); only the CHEAP
                # part (search -> handoff queue) runs before the next
                # submit — the heavy nav processing is deferred below it so
                # it overlaps the collector's next download
                prev = None
                if pending is not None:
                    prev = pop_pending(quick_only=True)
                # ---- apply queued handoffs to the device ledger --------
                if self._pipeline_handoffs:
                    chans, freqs, offs = [], [], []
                    for cand in self._pipeline_handoffs[:8]:
                        if cand.prn in self.active:
                            continue
                        idle = np.where(~self._pipeline_active_mask)[0]
                        if idle.size == 0:
                            break
                        ch = int(idle[0])
                        # re-map the detected code boundary to the nearest
                        # eligible window position: block is a multiple of
                        # n0, so shifting by any whole number of blocks
                        # preserves code phase — [n0, 2n0) is always
                        # eligible, no one-span deferral like the
                        # synchronous path's raw-offset handoff
                        delta = cand.sample_local_index - k * self.block
                        off = self.n0 + (delta % self.n0)
                        chans.append(ch)
                        freqs.append(cand.carrier_freq_hz)
                        offs.append(off)
                        prn_mirror[ch] = cand.prn - 1
                        self._pipeline_active_mask[ch] = True
                        self.active[cand.prn] = ch
                        self.telemetry.open_channel(ch, cand.prn)
                        self.nav.open_channel(ch, cand.prn)
                        self.acq_events.append((self.time_ms, cand))
                    self._pipeline_handoffs = []
                    if chans:
                        led = ft.apply_handoffs_device(
                            led, chans, freqs, offs)
                        self._codes_key = None    # codes refresh below
                codes_rows = self._codes_for_prns(prn_mirror)
                extra_args = ()
                rowmap = None
                if self._span_acq:
                    sel_np, rowmap = self.engine.steady_sel(
                        self.scheduler.candidates(set(self.active)))
                    extra_args = (jnp.asarray(sel_np),)
                stream_re, stream_im, g0 = \
                    self._advance_span_window(full)
                handle = ft.submit_span(led, stream_re, stream_im,
                                        codes_rows, k,
                                        extra_args=extra_args)
                led = handle.led
                pending = (handle, g0, rowmap)
                in_q.put(handle)          # collector starts the download
                if prev is not None:
                    # heavy nav of span n-1 overlaps span n's download
                    n_done, s = self._collect_pipelined(
                        prev[0], prev[1], on_block, result=prev[2],
                        skip_quick=True)
                    done += n_done
                    stop = stop or s
            if pending is not None:
                pop_pending()
        finally:
            # shut the collector down even on error paths (a
            # blocked daemon thread would pin the pending span's
            # device arrays for the process lifetime)
            try:
                in_q.put_nowait(None)
            except _qmod.Full:
                pass
            th.join(timeout=30.0)
        # sync the exact host ledger once at pipeline exit
        self.state = ft.absorb_led(led)._replace(
            prn_idx=np.asarray(prn_mirror))
        self._pipeline_active_mask = None
        self._codes_key = None
        if self._pipeline_handoffs:
            # the final span's search candidates arrived after the last
            # submit: hand them to the (now-synced) host ledger so they
            # are not lost behind a full pacing interval (mark_run
            # already recorded the search)
            import dataclasses as _dc

            remapped = [
                _dc.replace(
                    c, sample_local_index=self.n0
                    + (c.sample_local_index % self.n0))
                for c in self._pipeline_handoffs
            ]
            self._pipeline_handoffs = []
            self._handoff(remapped)
        if not stop:
            for samples, n_valid in leftovers:
                if self._process_block(samples, n_valid):
                    done += 1
                    if on_block is not None and on_block(self):
                        stop = True
                        break
        return done, eos or stop

    def _advance_span_window(self, full):
        """Span framing shared by the synchronous and pipelined paths:
        concatenate [window tail | len(full) fresh blocks] and roll the
        window to the new frontier (device slices, async). Returns
        (stream_re, stream_im, g0 = the span's window global start)."""
        keep = self.history + self.block
        parts_re = [self.window.re[self.block:]]
        parts_im = [self.window.im[self.block:]]
        for re, im in full:
            parts_re.append(jnp.asarray(re))
            parts_im.append(jnp.asarray(im))
        stream_re = jnp.concatenate(parts_re)
        stream_im = jnp.concatenate(parts_im)
        g0 = self.window.global_start
        self.window.load(stream_re[-keep:], stream_im[-keep:])
        self.window.global_start = g0 + len(full) * self.block
        self.window.blocks_fed += len(full)
        return stream_re, stream_im, g0

    def _codes_for_prns(self, prn_idx_np):
        key = ("pipe",) + tuple(prn_idx_np.tolist())
        if key != self._codes_key:
            self._codes_key = key
            self._codes_ch = self.codes_full[
                jnp.maximum(jnp.asarray(prn_idx_np), 0)]
        return self._codes_ch

    # ------------------------------------------------------------------
    def enable_observables(
        self,
        rinex_path: Optional[str] = None,
        every_ms: int = 1000,
        week: int = 0,
        ekf: bool = False,
    ) -> None:
        """Stream per-epoch observables while running: optionally write
        a RINEX 3 OBS file and/or run the EKF navigation filter
        (config ladder 5: observables at streaming rate)."""
        from ..nav.rinex_obs import RinexObsWriter

        if rinex_path:
            self._obs_writer = RinexObsWriter(rinex_path)
        self._obs_every_ms = every_ms
        self._obs_week = week
        if ekf:
            from ..nav.filter import NavigationFilter

            self.nav_filter = NavigationFilter()

    def _emit_observables(self) -> None:
        if not self._obs_every_ms:
            return
        if self.time_ms - self._obs_last_ms < self._obs_every_ms:
            return
        obs = self.nav.observables()
        if obs is None:
            return
        self._obs_last_ms = self.time_ms
        dopplers = {}
        for prn, ch in self.active.items():
            tr = self.telemetry.traces.get(ch)
            if tr is not None and tr.carr_freq.size:
                dopplers[prn] = float(
                    np.mean(tr.carr_freq[-20:])
                ) - self.f_if
        if self._obs_writer is not None:
            # LIVE traces only: closed traces of re-acquired PRNs would
            # otherwise shadow the current channel's C/N0
            cn0s = {
                t.prn: t.cn0_dbhz(coherent_s=self.spec.code_period_s)
                for t in self.telemetry.traces.values()
            }
            self._obs_writer.write_epoch(
                self._obs_week, obs["rx_time_nominal_s"],
                {
                    prn: (pr, dopplers.get(prn, 0.0), cn0s.get(prn))
                    for prn, pr in zip(obs["prns"], obs["pseudoranges_m"])
                },
            )
        if self.nav_filter is not None:
            if self.nav_filter.epochs and self._obs_last_update_ms is not None:
                # actual elapsed time since the last successful update
                # (observables may skip epochs when channels dip)
                self.nav_filter.predict(
                    (self.time_ms - self._obs_last_update_ms) / 1000.0
                )
            # Doppler observables make velocity (and clock drift)
            # directly observable — pseudorange-only leaves the
            # weak vertical axis to drift tens of m/s over short spans
            dop = ([dopplers.get(p, 0.0) for p in obs["prns"]]
                   if all(p in dopplers for p in obs["prns"]) else None)
            self.nav_filter.update(
                obs["pseudoranges_m"], obs["ephemerides"],
                obs["transmit_times_s"],
                dopplers_hz=dop,
                carrier_freq_hz=self.spec.carrier_freq_hz,
            )
            self._obs_last_update_ms = self.time_ms

    def run(self, max_blocks: Optional[int] = None,
            on_block=None, scan_blocks: int = 1,
            span_pipeline: bool = False) -> dict:
        """Drive the stream; ``on_block(receiver)`` fires after every
        processed block or span (live views, progress hooks —
        utils/live.py); a truthy return stops the run.

        ``scan_blocks > 1`` enables the device-resident steady state:
        once the constellation is in steady search mode, spans of that
        many blocks run as ONE device program (step_scan) — one host
        sync per span instead of per block — and paced re-searches run
        at span boundaries (steady pacing rounds up to the span length;
        the span is the scan path's scheduling quantum). Cold and warm
        starts (scheduler not in steady mode) keep single-block steps,
        so acquisition latency and TTFF are unaffected.

        ``span_pipeline=True`` additionally chains the steady-state
        spans' ledger ON DEVICE (_run_pipelined): span b+1 dispatches
        before span b's telemetry downloads, overlapping download +
        host nav with device compute. Semantics shift: in-scan
        acquisition handoffs apply one span late (re-mapped through
        code periodicity), and lost-channel bookkeeping trails by one
        span. Cold/warm behavior is unchanged.
        """
        from .acquisition import SearchMode

        blocks = 0
        can_scan = scan_blocks > 1 and self.fused is not None
        while max_blocks is None or blocks < max_blocks:
            k = 1
            if can_scan and self.scheduler.mode == SearchMode.STEADY:
                k = scan_blocks
                if max_blocks is not None and max_blocks - blocks < k:
                    # remainder shorter than a span: use the (warm)
                    # single-block path — a shrunken span would be a
                    # fresh static shape and a fresh device compile
                    k = 1
            if k > 1 and span_pipeline:
                budget = (None if max_blocks is None
                          else max_blocks - blocks)
                done, stop = self._run_pipelined(k, budget, on_block)
                blocks += done
                if stop or done == 0:
                    break
                continue
            if k > 1:
                done = self.step_scan(k)
                if done == 0:
                    break
                blocks += done
                # paced re-search at the span boundary (the in-span
                # blocks are search-free by construction)
                have_enough = (self.window.blocks_fed * self.block
                               >= self.acq_len)
                if have_enough and self.scheduler.due(self.time_ms):
                    with self.timers.stage("acquire", self.acq_len):
                        self._run_acquisition()
            else:
                if not self.step():
                    break
                blocks += 1
            if on_block is not None and on_block(self):
                # truthy return = stop request (e.g. TTFF measurement
                # stops at the first PVT fix)
                break
        return self.summary()

    def compute_pvt(self, smooth_epochs: int = 0):
        """Single-point PVT from decoded ephemerides + code timing.

        None until >=4 channels hold ephemeris + TOW, or when the
        geometry exceeds the configured GDOP gate. ``smooth_epochs``
        enables carrier-smoothed (Hatch) pseudoranges."""
        sol = self.nav.compute_pvt(
            smooth_epochs, self.f_if, self.spec.carrier_freq_hz
        )
        if sol is not None and sol.gdop > self.cfg.pvt.max_gdop:
            return None
        return sol

    def compute_velocity(self, position=None):
        """Velocity solution from per-channel carrier Doppler (requires
        a position: pass one or have compute_pvt succeed first)."""
        if position is None:
            sol = self.compute_pvt()
            if sol is None:
                return None
            position = sol.position_ecef_m
        dopplers = {}
        for trace_ch, trace in self.telemetry.traces.items():
            if trace.carr_freq.size:
                # settled loop average: instantaneous PLL output jitters
                # by a few Hz (~0.5 m/s per satellite)
                recent = trace.carr_freq[-50:]
                dopplers[trace_ch] = float(np.mean(recent)) - self.f_if
        return self.nav.compute_velocity(
            position, dopplers, self.spec.carrier_freq_hz
        )

    def summary(self) -> dict:
        traces = self.telemetry.all_traces()
        out = {
            "blocks": self.window.blocks_fed,
            "time_ms": self.time_ms,
            "stage_timing": self.timers.report(),
            "track_realtime_factor": round(
                self.timers.realtime_factor("track", self.fs), 2
            ),
            "tracked_prns": sorted(self.active),
            "nav": self.nav.status(),
            "ephemerides": sorted(self.nav.ephemerides),
            "channels": [
                {
                    "prn": t.prn,
                    "epochs": len(t.i_p),
                    "locked_fraction": (
                        float(np.mean(t.locked)) if t.locked.size else 0.0
                    ),
                    "cn0_dbhz": t.cn0_dbhz(coherent_s=self.spec.code_period_s),
                    "last_carr_freq": (
                        float(t.carr_freq[-1]) if t.carr_freq.size else None
                    ),
                    "last_doppler_hz": (
                        float(t.carr_freq[-1]) - self.f_if
                        if t.carr_freq.size else None
                    ),
                }
                for t in traces
            ],
        }
        if self.spec.name.startswith("galileo_e1"):
            from ..models.codes import galileo_e1 as _gal

            comp = "E1B" if self.spec.name.endswith("b") else "E1C"
            # surfaced so an operator can tell at a glance whether the
            # run used real ICD memory codes or the documented
            # surrogate family (real-sky captures need the ICD tables,
            # models/codes/galileo_e1.load_codes_hex)
            out["code_status"] = {
                "surrogate_codes": _gal.using_surrogate_codes(comp)}
        return out
