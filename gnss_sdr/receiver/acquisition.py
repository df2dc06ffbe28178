"""Acquisition engine + adaptive search scheduler.

Host-facing wrapper over the batched PCPS op (ops/pcps.py). The
scheduling policy is capability parity with the reference's
AcquisitionManager (reference: src/acquisition/do_acquisition.rs:33-74):
cold/warm/steady modes by tracked-satellite count, per-mode pacing
interval and candidate-list size. On the accelerator the whole PRN batch
is searched in one graph launch regardless of the candidate list (batch
compute is the same cost), so the candidate mask gates *handoff
eligibility* rather than per-worker dispatch.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

import functools

import jax

from ..config import AcqConfig
from ..models.constellation import SignalSpec
from ..ops import pcps

# jitted entry points: the engine runs once per pacing interval, but an
# un-jitted call dispatches hundreds of ops eagerly. The conv engine
# goes further: pcps.acquire_conv fuses search + lag refinement + fine
# Doppler into ONE dispatch (one host round trip per search).
_search_fft = jax.jit(
    pcps.pcps_search,
    static_argnames=("fs_hz", "n_int", "threshold", "mode",
                     "exclusion_samples", "pad_fft", "n_fft",
                     "coherent", "bit_edge_hypotheses"),
)
_fine_fft = jax.jit(
    pcps.fine_doppler,
    static_argnames=("fs_hz", "n_int", "zero_pad", "window_hz",
                     "squaring"),
)


class SearchMode(enum.Enum):
    COLD = "cold"
    WARM = "warm"
    STEADY = "steady"


@dataclasses.dataclass
class Candidate:
    """One acquisition verdict eligible for tracking handoff.

    Mirrors the reference's AcquisitionResult
    (do_acquisition.rs:94-102) with the carrier already fine-refined.
    """

    prn: int
    code_phase_samples: int
    code_phase_chips: float
    carrier_freq_hz: float      # includes IF
    ratio: float
    peak_power: float
    sample_local_index: int     # code-boundary sample, window-relative


class SearchScheduler:
    """Cold/warm/steady pacing (reference do_acquisition.rs:50-73)."""

    def __init__(self, cfg: AcqConfig):
        self.cfg = cfg
        self.mode = SearchMode.COLD
        self.last_run_ms: Optional[float] = None

    def update_mode(self, tracked_count: int) -> None:
        if tracked_count >= self.cfg.steady_threshold:
            self.mode = SearchMode.STEADY
        elif tracked_count >= self.cfg.warm_threshold:
            self.mode = SearchMode.WARM
        else:
            self.mode = SearchMode.COLD

    def pacing(self) -> tuple[int, int]:
        return {
            SearchMode.COLD: self.cfg.cold_pacing,
            SearchMode.WARM: self.cfg.warm_pacing,
            SearchMode.STEADY: self.cfg.steady_pacing,
        }[self.mode]

    def candidates(self, active_prns: set[int]) -> list[int]:
        """First ``search_size`` untracked PRNs (reference semantics:
        do_acquisition.rs:65-68)."""
        _, search_size = self.pacing()
        out = [
            prn for prn in range(1, self.cfg.n_prn + 1)
            if prn not in active_prns
        ]
        return out[:search_size]

    def due(self, now_ms: float) -> bool:
        interval_ms, _ = self.pacing()
        return self.last_run_ms is None or now_ms - self.last_run_ms >= interval_ms

    def mark_run(self, now_ms: float) -> None:
        self.last_run_ms = now_ms


class AcquisitionEngine:
    """Precomputed replicas + one-call batched search."""

    def __init__(
        self,
        cfg: AcqConfig,
        spec: SignalSpec,
        fs_hz: float,
        f_if_hz: float = 0.0,
    ):
        self.cfg = cfg
        self.spec = spec
        self.fs_hz = fs_hz
        self.f_if_hz = f_if_hz
        self.n_fft = spec.samples_per_code(fs_hz)
        n_code_rows = 1 if cfg.fdma_spacing_hz else cfg.n_prn
        # "auto" is the FFT engine on every platform; the conv engine
        # runs only when asked for (it is the route to in-span search)
        engine = "fft" if cfg.engine == "auto" else cfg.engine
        if engine not in ("fft", "conv"):
            raise ValueError(f"unknown acquisition engine {engine!r}")
        self.engine = engine
        if engine == "conv" and cfg.detector != "peak_avg":
            raise ValueError(
                "engine='conv' supports the peak_avg detector only")
        if engine == "conv":
            self.code_ffts = None      # the conv engine needs no FFTs
        elif cfg.pad_fft:
            self.code_ffts = pcps.code_replica_ffts_padded(
                spec, fs_hz, n_code_rows
            )
        else:
            self.code_ffts = pcps.code_replica_ffts(spec, fs_hz, n_code_rows)
        base = pcps.doppler_grid(cfg.doppler_span_hz, cfg.doppler_step_hz)
        self._base_grid_len = base.shape[0]
        self.grid = base + np.float32(f_if_hz)
        self.code_samples = np.stack(
            [
                spec.sample_code(p, spec.code_rate_hz, fs_hz)
                for p in range(1, n_code_rows + 1)
            ]
        ).astype(np.float32)
        if engine == "conv":
            import jax.numpy as jnp

            self.decim = self._pick_decim()
            # boxcar-decimated replicas: the exact matched filter for
            # boxcar-decimated samples (chip-edge transitions average
            # the same way on both sides of the correlation)
            coarse = (
                self.code_samples
                .reshape(n_code_rows, self.n_fft // self.decim, self.decim)
                .mean(axis=-1)
                if self.decim > 1 else self.code_samples
            )
            # device-resident replica tables, passed (not captured) into
            # every search: a closure-captured constant is re-embedded
            # in every compiled program, an argument is not
            self._codes_dev = jnp.asarray(self.code_samples)
            self._codes_coarse_dev = jnp.asarray(
                np.ascontiguousarray(coarse, dtype=np.float32))
            self._sel_identity = np.eye(n_code_rows, dtype=np.float32)
        else:
            self.decim = 1

    def _pick_decim(self) -> int:
        """Coarse-stage decimation (AcqConfig.coarse_decim semantics)."""
        cfg = self.cfg
        if cfg.coarse_decim:
            r = cfg.coarse_decim
            if r > 1 and self.n_fft % r:
                raise ValueError(
                    f"coarse_decim={r} does not divide samples/code "
                    f"({self.n_fft})"
                )
            return r
        # auto: largest power-of-two divisor of samples/code keeping
        # >= 1 sample/chip (2/chip for BOC — the subcarrier doubles the
        # occupied bandwidth)
        floor = self.spec.code_length_chips * (
            2 if self.spec.boc_cycles_per_chip else 1
        )
        r, k = 1, 2
        while self.n_fft % k == 0 and self.n_fft // k >= floor:
            r, k = k, k * 2
        return r

    @property
    def _fine_squaring(self) -> bool:
        """Square before the fine-Doppler line search when ANY BPSK
        modulation flips within the coherent window: secondary/NH codes,
        or data symbols shorter than ~20 ms (Galileo E1B flips every
        4 ms code period, GLONASS meander halves every 10 ms) — a flip
        splits the carrier line and biases the estimate onto a Costas
        alias (observed: E1B handoff landing 62.5 Hz off, a stable
        false equilibrium of the 250 Hz-sampled atan discriminator)."""
        if self.spec.secondary_code is not None:
            return True
        symbol_ms = self.spec.symbols_per_bit * self.spec.code_period_ms
        return symbol_ms < 20

    @property
    def _fine_n_sub(self) -> int:
        """Sub-period split for fine_doppler_conv's unambiguous
        cross-product stage (see ops/pcps.py): with squaring, the
        per-period line search cannot tell offsets apart that differ by
        k/(2*T_period) — sub-period phase slopes can. Smallest divisor
        of the period sample count giving >= 2 sub-segments whose
        unambiguous range n_sub/(2*T_period) covers half a coarse
        Doppler bin plus margin."""
        if not self._fine_squaring:
            return 1
        t_period = self.n_fft / self.fs_hz
        need = max(2.0, 2.0 * t_period * (self.cfg.doppler_step_hz / 2.0
                                          + 150.0))
        for s in range(int(np.ceil(need)), 65):
            if self.n_fft % s == 0:
                return s
        return 1

    @property
    def samples_needed(self) -> int:
        n_int = self.cfg.non_coherent_ms // self.spec.code_period_ms
        # the pow2 and conv linear paths correlate two-period blocks:
        # +1 trailing period
        extra = 1 if (self.cfg.pad_fft or self.engine == "conv") else 0
        return (n_int + extra) * self.n_fft

    def search(
        self,
        samples: np.ndarray,
        window_offset: int = 0,
        allowed_prns: Optional[set[int]] = None,
    ) -> list[Candidate]:
        """Run PCPS (+ optional fine Doppler) over a sample chunk.

        ``samples`` must be ``samples_needed`` long — either a complex
        array or a planar ``(re, im)`` float32 pair (the receiver's
        window is planar; the conv engine consumes it copy-free).
        ``window_offset`` is the chunk's position inside the caller's
        window so candidates carry window-relative boundary indices
        (the reference's local_tail + code_phase,
        do_acquisition.rs:220).

        FDMA mode (cfg.fdma_spacing_hz != 0): one search per frequency
        channel with the grid shifted by k * spacing; detected channels
        are reported as pseudo-PRN = channel-list index + 1 (they all
        share code row 0).
        """
        if self.cfg.fdma_spacing_hz:
            out = []
            for i, k in enumerate(self.cfg.fdma_channels):
                shift = np.float32(k * self.cfg.fdma_spacing_hz)
                cands = self._search_grid(
                    samples, self.grid[:self._base_grid_len] + shift,
                    window_offset,
                )
                for c in cands:
                    c.prn = i + 1
                    if allowed_prns is None or c.prn in allowed_prns:
                        out.append(c)
            out.sort(key=lambda c: -c.ratio)
            return out
        return self._search_grid(samples, self.grid, window_offset,
                                 allowed_prns)

    def conv_search_device(self, s_re, s_im, sel=None):
        """Raw conv search as a JIT-COMPOSABLE graph piece: device
        arrays in and out — no host logic. The steady-state receiver
        embeds this INSIDE the multi-block scan program
        (FusedTracker.span_extra), so the paced re-search costs zero
        extra host round trips; candidates form host-side afterwards
        (candidates_from_conv). ``sel`` selects replica rows ([B,
        n_prn] 0/1; defaults to the full identity) — the steady
        re-search passes the 8-row candidate bucket, ~4x less work
        than the full constellation. Only valid for the conv engine
        (accelerator backends)."""
        if self.engine != "conv":
            raise ValueError("conv_search_device requires engine='conv'")
        n_int = self.cfg.non_coherent_ms // self.spec.code_period_ms
        return pcps.acquire_conv.__wrapped__(
            s_re, s_im,
            self._codes_dev, self._codes_coarse_dev,
            self._sel_identity if sel is None else sel,
            np.ascontiguousarray(self.grid, dtype=np.float32),
            fs_hz=self.fs_hz, n_int=n_int, decim=self.decim,
            threshold=self._default_threshold(n_int, self.grid),
            seg_width=self.cfg.seg_width,
            fine=self.cfg.fine_doppler,
            fine_window_hz=float(self.cfg.doppler_step_hz),
            fine_squaring=self._fine_squaring,
            fine_n_sub=self._fine_n_sub,
        )

    def steady_sel(self, allowed_prns) -> tuple[np.ndarray, list]:
        """8-row selection bucket + rowmap for the in-scan steady
        re-search (stable shape across spans; zero rows are never
        detected)."""
        n_rows = self.code_samples.shape[0]
        rowmap = [p for p in sorted(allowed_prns)
                  if 1 <= p <= n_rows][:8]
        sel = np.zeros((8, n_rows), np.float32)
        for i, p in enumerate(rowmap):
            sel[i, p - 1] = 1.0
        return sel, rowmap + [None] * (8 - len(rowmap))

    def candidates_from_conv(self, res, window_offset: int,
                             allowed_prns: Optional[set[int]],
                             rowmap=None) -> list[Candidate]:
        """Host-side candidate forming from a (downloaded)
        conv_search_device result — the back half of
        _search_conv_grid, split out for the in-scan path."""
        detected = np.asarray(res.detected)
        if not detected.any():
            return []
        freqs = np.asarray(res.carrier_freq_hz)
        if rowmap is None:
            rowmap = list(range(1, self.code_samples.shape[0] + 1))
        return self._build_candidates(
            res, freqs, rowmap, window_offset, allowed_prns)

    def _default_threshold(self, n_int: int, grid) -> float:
        """Threshold for the default peak/avg detector, with the
        coherent-grouping auto-rescale (the in-scan path supports the
        default detector only — the conv op takes one scalar)."""
        cfg = self.cfg
        threshold = cfg.detection_threshold
        k = max(1, cfg.coherent_ms // self.spec.code_period_ms)
        if cfg.threshold_auto_scale and (
            k > 1 or cfg.bit_edge_hypotheses > 1
        ):
            threshold = pcps.peak_avg_threshold(
                threshold,
                n_groups=pcps.coherent_group_count(
                    n_int, k, cfg.bit_edge_hypotheses
                ),
                n_cells=float(len(grid)) * self.n_fft,
                hypotheses=cfg.bit_edge_hypotheses,
            )
        return threshold

    def _search_grid(
        self,
        samples: np.ndarray,
        grid: np.ndarray,
        window_offset: int,
        allowed_prns: Optional[set[int]] = None,
    ) -> list[Candidate]:
        n_int = self.cfg.non_coherent_ms // self.spec.code_period_ms
        cfg = self.cfg
        if cfg.detector == "two_peak":
            threshold = cfg.two_peak_threshold
            excl = int(round(
                cfg.two_peak_exclusion_chips * self.fs_hz
                / self.spec.code_rate_hz
            ))
        elif cfg.detector == "cfar":
            threshold, excl = cfg.cfar_scale, 0
        else:
            threshold, excl = cfg.detection_threshold, 0
            k = max(1, cfg.coherent_ms // self.spec.code_period_ms)
            if cfg.threshold_auto_scale and (
                k > 1 or cfg.bit_edge_hypotheses > 1
            ):
                # coherent grouping / hypothesis max-combine change the
                # noise-only peak/avg floor; rescale the user threshold
                # to keep the same margin over it (see
                # pcps.peak_avg_threshold)
                threshold = pcps.peak_avg_threshold(
                    threshold,
                    n_groups=pcps.coherent_group_count(
                        n_int, k, cfg.bit_edge_hypotheses
                    ),
                    n_cells=float(len(grid)) * self.n_fft,
                    hypotheses=cfg.bit_edge_hypotheses,
                )
        if self.engine == "conv":
            return self._search_conv_grid(
                samples, grid, window_offset, allowed_prns,
                n_int=n_int, threshold=threshold,
            )
        else:
            if isinstance(samples, tuple):
                samples = (samples[0] + 1j * samples[1]).astype(
                    np.complex64)
            res = _search_fft(
                np.ascontiguousarray(samples, dtype=np.complex64),
                self.code_ffts,
                np.ascontiguousarray(grid, dtype=np.float32),
                fs_hz=self.fs_hz,
                n_int=n_int,
                threshold=threshold,
                mode=cfg.detector,
                exclusion_samples=excl,
                pad_fft=cfg.pad_fft,
                n_fft=self.n_fft if cfg.pad_fft else None,
                coherent=max(1, cfg.coherent_ms
                             // self.spec.code_period_ms),
                bit_edge_hypotheses=cfg.bit_edge_hypotheses,
            )
        detected = np.asarray(res.detected)
        if not detected.any():
            return []

        freqs = np.asarray(res.carrier_freq_hz)
        if self.cfg.fine_doppler:
            fine = np.asarray(
                _fine_fft(
                    np.ascontiguousarray(samples, dtype=np.complex64),
                    self.code_samples,
                    res.code_phase_samples,
                    res.carrier_freq_hz,
                    fs_hz=self.fs_hz,
                    n_int=n_int,
                    zero_pad=self.cfg.fine_doppler_zero_pad,
                    window_hz=self.cfg.doppler_step_hz,
                    # secondary/NH codes AND fast data symbols
                    # (E1B 4 ms, GLONASS 10 ms halves) split the
                    # coherent line; wipe either by squaring
                    squaring=self._fine_squaring,
                )
            )
            freqs = np.where(detected, fine, freqs)

        rowmap = list(range(1, self.code_samples.shape[0] + 1))
        return self._build_candidates(
            res, freqs, rowmap, window_offset, allowed_prns
        )

    def _search_conv_grid(
        self,
        samples: np.ndarray,
        grid: np.ndarray,
        window_offset: int,
        allowed_prns: Optional[set[int]],
        *,
        n_int: int,
        threshold: float,
    ) -> list[Candidate]:
        """Conv-engine search: one fused acquire_conv dispatch with the
        candidate list bucketed into the replica batch via a selection
        matmul (see pcps.acquire_conv)."""
        n_rows = self.code_samples.shape[0]
        if (
            allowed_prns is None
            or self.cfg.fdma_spacing_hz
            or len(allowed_prns) >= n_rows
        ):
            sel = self._sel_identity
            rowmap: list[Optional[int]] = list(range(1, n_rows + 1))
        else:
            rowmap = sorted(
                p for p in allowed_prns if 1 <= p <= n_rows
            )
            if not rowmap:
                return []
            # only two bucket shapes ever reach the jit cache: 8 (the
            # steady-state re-search, reference masks <= 5 PRNs,
            # do_acquisition.rs:62-73) and n_rows. A tight pow2 bucket
            # would recompile as the candidate count walks down —
            # ruinous where compiles are expensive.
            b = 8 if len(rowmap) <= 8 else n_rows
            sel = np.zeros((b, n_rows), np.float32)
            for i, p in enumerate(rowmap):
                sel[i, p - 1] = 1.0
            # zero pad rows: zero replica -> zero power -> ratio 0,
            # never detected
            rowmap = rowmap + [None] * (b - len(rowmap))
        if isinstance(samples, tuple):
            s_re, s_im = samples
            if isinstance(s_re, np.ndarray):
                s_re = np.ascontiguousarray(s_re, dtype=np.float32)
                s_im = np.ascontiguousarray(s_im, dtype=np.float32)
            # else: device-resident planar slices — pass through with
            # zero host round trips
        else:
            s_re = np.ascontiguousarray(np.real(samples), dtype=np.float32)
            s_im = np.ascontiguousarray(np.imag(samples), dtype=np.float32)
        res = pcps.acquire_conv(
            s_re,
            s_im,
            self._codes_dev,
            self._codes_coarse_dev,
            sel,
            np.ascontiguousarray(grid, dtype=np.float32),
            fs_hz=self.fs_hz,
            n_int=n_int,
            decim=self.decim,
            threshold=threshold,
            seg_width=self.cfg.seg_width,
            fine=self.cfg.fine_doppler,
            fine_window_hz=float(self.cfg.doppler_step_hz),
            fine_squaring=self._fine_squaring,
            fine_n_sub=self._fine_n_sub,
        )
        detected = np.asarray(res.detected)
        if not detected.any():
            return []
        freqs = np.asarray(res.carrier_freq_hz)
        return self._build_candidates(
            res, freqs, rowmap, window_offset, allowed_prns
        )

    def _build_candidates(
        self,
        res,
        freqs: np.ndarray,
        rowmap: list,
        window_offset: int,
        allowed_prns: Optional[set[int]],
    ) -> list[Candidate]:
        detected = np.asarray(res.detected)
        ratios = np.asarray(res.ratio)
        peaks = np.asarray(res.peak_power)
        lags = np.asarray(res.code_phase_samples)
        out = []
        for idx in np.where(detected)[0]:
            prn = rowmap[int(idx)]
            if prn is None:
                continue
            if allowed_prns is not None and prn not in allowed_prns:
                continue
            lag = int(lags[idx])
            out.append(
                Candidate(
                    prn=prn,
                    code_phase_samples=lag,
                    code_phase_chips=lag
                    * self.spec.code_rate_hz
                    / self.fs_hz,
                    carrier_freq_hz=float(freqs[idx]),
                    ratio=float(ratios[idx]),
                    peak_power=float(peaks[idx]),
                    sample_local_index=window_offset + lag,
                )
            )
        out.sort(key=lambda c: -c.ratio)
        return out
