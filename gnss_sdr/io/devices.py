"""SDR device abstraction layer.

Capability parity with the reference's device stack: the SoapySDR-backed
``SdrDeviceWrapper`` trait (~25 methods: antennas, gains, frequencies,
rates, bandwidth, streams — reference src/sdr_store/sdr_wrapper.rs:51-202),
the JSON-config RTL-SDR driver (src/sdr_store/rtl_sdr.rs:31-120), the
name-based factory (sdr_wrapper.rs:246-270) and the test MockDevice
(src/sdr_mock/device_mock.rs:7-69).

Accelerators cannot talk USB (SURVEY.md section 2), so live radios are an I/O
boundary: ``SoapyDevice`` binds through the SoapySDR *Python* module when
present (optional; never required), while ``MockDevice`` and the
file/synthetic sources cover tests and replay. Every device exposes the
``SampleSource`` protocol, so the Receiver is device-agnostic.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SdrInfo:
    """Device identity (reference SdrInfo, sdr_wrapper.rs:23-35)."""

    driver: str = ""
    label: str = ""
    serial: str = ""
    manufacturer: str = ""
    tuner: str = ""


class SdrDevice:
    """Abstract device interface (reference trait surface,
    sdr_wrapper.rs:51-202). Concrete devices override the private
    hooks; public methods implement the config plumbing once."""

    def __init__(self):
        self.info = SdrInfo()
        self._center_freq = 0.0
        self._sample_rate = 0.0
        self._bandwidth = 0.0
        self._gain = 0.0
        self._agc = False
        self._antenna = ""
        self._ppm = 0.0
        self._streaming = False

    # -- capability queries ------------------------------------------------
    def list_antennas(self) -> list[str]:
        return ["RX"]

    def gain_range(self) -> tuple[float, float]:
        return (0.0, 50.0)

    def frequency_range(self) -> tuple[float, float]:
        return (24e6, 1.8e9)

    def sample_rate_range(self) -> tuple[float, float]:
        return (225e3, 3.2e6)

    # -- setters (reference rtl_sdr.rs config keys) ------------------------
    def set_center_frequency(self, hz: float) -> None:
        lo, hi = self.frequency_range()
        if not lo <= hz <= hi:
            raise ValueError(f"frequency {hz} outside [{lo}, {hi}]")
        self._center_freq = hz

    def set_sample_rate(self, hz: float) -> None:
        lo, hi = self.sample_rate_range()
        if not lo <= hz <= hi:
            raise ValueError(f"sample rate {hz} outside [{lo}, {hi}]")
        self._sample_rate = hz

    def set_bandwidth(self, hz: float) -> None:
        self._bandwidth = hz

    def set_gain(self, db: float) -> None:
        lo, hi = self.gain_range()
        self._gain = min(max(db, lo), hi)

    def set_agc(self, enable: bool) -> None:
        self._agc = enable

    def set_antenna(self, name: str) -> None:
        if name not in self.list_antennas():
            raise ValueError(f"unknown antenna {name!r}")
        self._antenna = name

    def set_frequency_correction_ppm(self, ppm: float) -> None:
        self._ppm = ppm

    # -- getters -----------------------------------------------------------
    @property
    def center_frequency(self) -> float:
        return self._center_freq

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @property
    def fs_hz(self) -> float:  # SampleSource protocol
        return self._sample_rate

    @property
    def gain(self) -> float:
        return self._gain

    # -- config plumbing (reference rtl_sdr.rs:31-120: JSON keys) ----------
    def configure(self, config_json: str) -> None:
        cfg = json.loads(config_json)
        known = {
            "center_freq_hz": self.set_center_frequency,
            "sample_rate_hz": self.set_sample_rate,
            "bandwidth_hz": self.set_bandwidth,
            "gain_db": self.set_gain,
            "enable_agc": self.set_agc,
            "antenna": self.set_antenna,
            "ppm": self.set_frequency_correction_ppm,
        }
        for key, value in cfg.items():
            if key not in known:
                raise ValueError(f"unknown device config key {key!r}")
            known[key](value)

    # -- streaming ---------------------------------------------------------
    def activate_stream(self) -> None:
        self._streaming = True

    def deactivate_stream(self) -> None:
        self._streaming = False

    def read(self, n: int) -> Optional[np.ndarray]:
        if not self._streaming:
            raise RuntimeError("stream not activated")
        return self._read_samples(n)

    def _read_samples(self, n: int) -> Optional[np.ndarray]:
        raise NotImplementedError


class MockDevice(SdrDevice):
    """Deterministic fake device (reference MockDevice role): replays a
    provided array, or noise if none given."""

    def __init__(self, samples: Optional[np.ndarray] = None, seed: int = 0):
        super().__init__()
        self.info = SdrInfo(
            driver="mock", label="Mock SDR", serial="00000001",
            manufacturer="gnss_sdr", tuner="mock-tuner",
        )
        self._samples = samples
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def _read_samples(self, n: int) -> Optional[np.ndarray]:
        if self._samples is None:
            return (
                self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n)
            ).astype(np.complex64)
        if self._pos >= self._samples.size:
            return None
        out = self._samples[self._pos:self._pos + n]
        self._pos += out.size
        return np.asarray(out, np.complex64)


class SoapyDevice(SdrDevice):
    """Live SoapySDR-backed device (rtlsdr/hackrf/airspy/...).

    Optional dependency: requires the SoapySDR Python module, which this
    image does not ship; constructing without it raises with guidance.
    The driver surface mirrors the reference's stub set
    (src/sdr_store/{airspy,bladerf,hackrf,lime_sdr,pluto_sdr,usrp}.rs).
    """

    SUPPORTED_DRIVERS = (
        "rtlsdr", "hackrf", "airspy", "bladerf", "lime", "plutosdr", "uhd",
    )

    def __init__(self, driver: str, args: str = ""):
        super().__init__()
        try:
            import SoapySDR  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "SoapySDR Python bindings are not installed; use the file, "
                "synthetic, or mock sources, or install SoapySDR for live "
                f"{driver} capture"
            ) from e
        self._soapy = SoapySDR.Device(dict(driver=driver) | (
            dict(kv.split("=") for kv in args.split(",")) if args else {}
        ))
        self.info = SdrInfo(driver=driver, label=str(self._soapy))
        self._stream = None

    def activate_stream(self) -> None:
        import SoapySDR  # type: ignore

        self._soapy.setFrequency(SoapySDR.SOAPY_SDR_RX, 0, self._center_freq)
        self._soapy.setSampleRate(SoapySDR.SOAPY_SDR_RX, 0, self._sample_rate)
        self._soapy.setGain(SoapySDR.SOAPY_SDR_RX, 0, self._gain)
        self._stream = self._soapy.setupStream(
            SoapySDR.SOAPY_SDR_RX, SoapySDR.SOAPY_SDR_CF32
        )
        self._soapy.activateStream(self._stream)
        super().activate_stream()

    def _read_samples(self, n: int) -> Optional[np.ndarray]:
        out = np.empty(n, np.complex64)
        sr = self._soapy.readStream(self._stream, [out], n, timeoutUs=100000)
        if sr.ret <= 0:
            return None
        return out[: sr.ret]


def open_device(driver: str, **kwargs) -> SdrDevice:
    """Factory by driver name (reference start_device_with_name,
    sdr_wrapper.rs:246-270: only rtlsdr constructs there; everything
    else was a 0-LoC stub — here all SoapySDR drivers route through
    SoapyDevice and mock is first-class)."""
    if driver == "mock":
        return MockDevice(**kwargs)
    if driver in SoapyDevice.SUPPORTED_DRIVERS:
        return SoapyDevice(driver, **kwargs)
    raise ValueError(
        f"unknown SDR driver {driver!r}; available: mock, "
        + ", ".join(SoapyDevice.SUPPORTED_DRIVERS)
    )
