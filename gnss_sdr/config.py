"""Configuration system.

The reference splits its knobs between one TOML file
(reference: src/config/app_config.rs:8-51, app_config.toml) and
compile-time statics scattered through the DSP modules
(reference: src/tracking/do_tracking.rs:16-29,
src/acquisition/do_acquisition.rs:20-23). Here *every* operating knob a
GNSS engineer tunes is a field on a frozen dataclass: frozen so configs
are hashable and usable as jit static arguments, with TOML round-trip for
files. Derived IF follows the reference rule IF = center_freq - carrier
(reference app_config.rs:48).
"""
from __future__ import annotations

import dataclasses
import tomllib
from typing import Optional

from . import constants as C


@dataclasses.dataclass(frozen=True)
class SdrConfig:
    """Front-end device settings (reference: src/sdr_store/sdr_wrapper.rs:38-49)."""

    driver: str = "file"              # file | synthetic | rtlsdr | mock
    center_freq_hz: float = C.GPS_L1_FREQ_HZ
    sample_rate_hz: float = 2_048_000.0
    bandwidth_hz: float = 2_048_000.0
    gain_db: float = 40.0
    enable_agc: bool = False
    path: str = ""                    # sample file for the file driver
    file_format: str = "int8_real"    # int8_real | int8_iq | f32_iq


@dataclasses.dataclass(frozen=True)
class RfConfig:
    """Digital front-end (reference: src/rf/frontend.rs:32-67)."""

    freq_if_hz: Optional[float] = None   # None -> derived center - carrier
    output_sample_rate_hz: float = 2_048_000.0
    dc_alpha: float = 0.001              # one-pole DC tracker coefficient
    # conditioning defaults off for already-clean complex baseband
    # streams; real SDR front ends enable DC removal + mixing
    enable_dc_removal: bool = False
    enable_mixing: bool = True
    # polyphase decimating FIR (the resampler the reference left TODO,
    # reference frontend.rs:64-66)
    decimation: int = 1
    fir_taps_per_phase: int = 8
    # pulse blanking: zero samples with envelope > sigma * block RMS
    # (also a reference TODO, frontend.rs:64); 0 disables
    pulse_blank_sigma: float = 0.0
    # digital AGC toward unit RMS (digital counterpart of the hardware
    # enable_agc device flag)
    enable_digital_agc: bool = False


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """PCPS acquisition (reference: src/acquisition/do_acquisition.rs:20-23,237)."""

    signal: str = "gps_l1ca"
    doppler_span_hz: float = 14_000.0    # searched band (centered on 0)
    doppler_step_hz: float = 500.0
    n_prn: int = 32
    non_coherent_ms: int = 10            # LONG_SAMPLES_LENGTH
    # code periods summed coherently before squaring (weak-signal
    # sensitivity; keep residual doppler << 1/(coherent_ms) and below
    # the data-bit period)
    coherent_ms: int = 1
    # data-bit-edge group-start hypotheses for coherent integration
    # (max-combined power cubes; see ops.pcps.pcps_power). 1 = off;
    # set to coherent_ms/code_period_ms to try every offset.
    bit_edge_hypotheses: int = 1
    # rescale detection_threshold to the coherent/hypothesis mode's
    # noise floor (pcps.peak_avg_threshold); the raw reference 7.0 is
    # only calibrated for 10 x 1 ms non-coherent integration
    threshold_auto_scale: bool = True
    # detector: "peak_avg" = peak/avg > detection_threshold (reference
    # do_acquisition.rs:229-238); "two_peak" = first/second peak ratio
    # with +/-1 chip exclusion (legacy acquisition_bk.rs:342-399);
    # "cfar" = peak > cfar_scale * mean (legacy CA-CFAR,
    # acquisition_bk.rs:306-340, scale 2*invgammp(0.8,2) ~ 5.99)
    detector: str = "peak_avg"
    detection_threshold: float = 7.0     # peak/avg test
    two_peak_threshold: float = 1.4
    two_peak_exclusion_chips: float = 1.0
    cfar_scale: float = 5.988
    # adaptive search pacing: (interval_ms, prns_per_round) per mode
    # (reference do_acquisition.rs:58-73)
    cold_pacing: tuple[int, int] = (500, 32)
    warm_pacing: tuple[int, int] = (1000, 8)
    steady_pacing: tuple[int, int] = (2000, 5)
    warm_threshold: int = 1              # tracked count >= -> warm
    steady_threshold: int = 5            # tracked count >= -> steady
    # optional fine-Doppler refinement stage (legacy reference parity,
    # reference acquisition_bk.rs:215-302)
    fine_doppler: bool = True
    fine_doppler_zero_pad: int = 8
    # compute engine: "fft" = batched-FFT circular/padded correlation;
    # "conv" = matched-filter convolution in bf16 (FFT-free; the only
    # engine that runs inside the span program, Receiver.run
    # scan_blocks); "auto" = fft on every platform
    engine: str = "auto"
    # power-of-two linear-correlation FFTs (costs one extra code period
    # of samples)
    pad_fft: bool = False
    # coarse-to-fine search (conv engine): stage 1 searches boxcar-
    # decimated samples (~1 sample/chip BPSK, 2/chip BOC), stage 2
    # refines the winners' code phase at full rate. 0 = auto-pick the
    # largest decimation that divides samples/code and respects the
    # floor above; 1 = disabled (always full rate); N = force N.
    # Sensitivity note: the coarse stage costs up to ~2-3 dB of
    # detection margin at 1 sample/chip (peak scalloping); set 1 for
    # weak-signal work.
    coarse_decim: int = 0
    # matched-filter segmentation width for the conv engine (taps per
    # input channel)
    seg_width: int = 128
    # FDMA (GLONASS): satellites share one code and are separated by
    # carrier channel k * spacing; acquisition searches each channel's
    # sub-grid and reports pseudo-PRN = channel index + 1
    fdma_spacing_hz: float = 0.0
    fdma_channels: tuple[int, ...] = ()

    @property
    def doppler_bins(self) -> int:
        return int(self.doppler_span_hz / self.doppler_step_hz) + 1


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """DLL/PLL tracking loops (reference: src/tracking/do_tracking.rs:16-29)."""

    signal: str = "gps_l1ca"
    n_channels: int = 15
    # lock detector: "power" = absolute prompt power > lock_threshold
    # (reference semantics, do_tracking.rs:16,186-188 — input-scale
    # dependent); "costas" = scale-invariant normalized detector
    # (I^2-Q^2)/(I^2+Q^2) > costas_lock_threshold
    lock_mode: str = "power"
    lock_threshold: float = 15.0
    costas_lock_threshold: float = 0.4
    max_lost_epochs: int = 20
    pll_bandwidth_hz: float = 25.0
    pll_damping: float = 0.7
    pll_gain: float = 0.25
    dll_bandwidth_hz: float = 2.0
    dll_damping: float = 0.7
    dll_gain: float = 1.0
    integration_s: float = 0.001         # PLL_SUM_CARR / DLL_SUM_CODE
    early_late_chips: float = 0.5
    # correlator implementation: "shift" = single-gather fast path with
    # E/L spacing quantized to an integer sample shift (error < 1e-5
    # chip at practical rates); "exact" = three-gather reference-exact
    # floor(cp +/- spacing) lookups (reference do_tracking.rs:251-263);
    # "slice" = contiguous slices of a sampled code table; "fused" =
    # the slice arithmetic as one block step per sample block
    # (receiver/fused_runner.py: one Pallas kernel on the GPU, chained
    # on device across spans)
    correlator: str = "shift"
    # linearly interpolate the code replica between chips (suppresses
    # the sample-grid code-phase quantization bias at one extra gather)
    interp_code: bool = False
    # carrier-aided code tracking: steer the code rate by the measured
    # carrier Doppler scaled by code_rate/carrier_freq (absent from the
    # reference; standard receiver practice)
    carrier_aiding: bool = False
    # static epoch window margin in samples beyond nominal samples/code
    window_margin: int = 8
    # telemetry wire format for the fused span's device->host download
    # (fused_runner.run_blocks): "f32" ships every epoch's full
    # EpochTelemetry (bit-exact, the test/parity format); "slim" ships
    # prompt I/Q as bf16, packed flags, epoch timing and chip phase per
    # epoch and the diagnostic columns (E/L, loop errors, rates) at a
    # stride — ~4x fewer bytes; "auto" = slim on the GPU, f32 on CPU
    telemetry_wire: str = "auto"


@dataclasses.dataclass(frozen=True)
class PvtConfig:
    """(reference: src/config/app_config.rs:24-27 plus legacy L6 surface)."""

    enable: bool = True
    min_satellites: int = 4
    max_iterations: int = 10
    elevation_mask_deg: float = 5.0
    max_gdop: float = 20.0               # reject degenerate geometries


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    file_type: str = "json"
    telemetry: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (no reference counterpart)."""

    channel_axis: int = 1     # devices sharding tracking channels / PRNs
    time_axis: int = 1        # devices sharding sample-time blocks
    mesh_axis_names: tuple[str, str] = ("time", "channel")


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    sdr: SdrConfig = SdrConfig()
    rf: RfConfig = RfConfig()
    acq: AcqConfig = AcqConfig()
    track: TrackConfig = TrackConfig()
    pvt: PvtConfig = PvtConfig()
    output: OutputConfig = OutputConfig()
    parallel: ParallelConfig = ParallelConfig()
    block_ms: int = 100                 # samples streamed per device step

    @property
    def fs_hz(self) -> float:
        return self.rf.output_sample_rate_hz

    @property
    def f_if_hz(self) -> float:
        if self.rf.freq_if_hz is not None:
            return self.rf.freq_if_hz
        from .models.constellation import get_signal

        return self.sdr.center_freq_hz - get_signal(self.acq.signal).carrier_freq_hz


def _build(cls, data: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(f"unknown {cls.__name__} key: {key!r}")
        ftype = fields[key].type
        if isinstance(value, dict):
            value = _build(_SECTION_TYPES[key], value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return cls(**kwargs)


_SECTION_TYPES = {
    "sdr": SdrConfig,
    "rf": RfConfig,
    "acq": AcqConfig,
    "track": TrackConfig,
    "pvt": PvtConfig,
    "output": OutputConfig,
    "parallel": ParallelConfig,
}


def from_toml(path: str) -> ReceiverConfig:
    """Load a ReceiverConfig from a TOML file (reference app_config.rs:44-51).

    Unknown keys are a hard error — the reference's serde setup silently
    mismatched key names (SURVEY.md section 5 notes center_freq_hz vs
    center_frequency_hz); strictness here prevents that failure class.
    """
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return _build(ReceiverConfig, data)


def to_toml_dict(cfg: ReceiverConfig) -> dict:
    return dataclasses.asdict(cfg)
