"""SDR device layer tests (reference: sdr_wrapper trait + MockDevice +
rtl_sdr JSON config, src/sdr_store/ + src/sdr_mock/)."""
import json
import sys
import types

import numpy as np
import pytest

from gnss_sdr.io import MockDevice, open_device
from gnss_sdr.models import SatelliteScenario, synthesize


class TestMockDevice:
    def test_json_config(self):
        # the reference's RTL-SDR config keys (rtl_sdr.rs:31-120)
        dev = open_device("mock")
        dev.configure(json.dumps({
            "center_freq_hz": 1_575_420_000.0,
            "sample_rate_hz": 2_048_000.0,
            "bandwidth_hz": 2_048_000.0,
            "gain_db": 40.0,
            "enable_agc": True,
            "antenna": "RX",
        }))
        assert dev.center_frequency == 1_575_420_000.0
        assert dev.sample_rate == 2_048_000.0
        assert dev.gain == 40.0

    def test_unknown_config_key_rejected(self):
        dev = MockDevice()
        with pytest.raises(ValueError, match="center_frequency_hz"):
            dev.configure(json.dumps({"center_frequency_hz": 1.0}))

    def test_out_of_range_rejected(self):
        dev = MockDevice()
        with pytest.raises(ValueError):
            dev.set_center_frequency(1.0)
        with pytest.raises(ValueError):
            dev.set_sample_rate(100e6)

    def test_stream_requires_activation(self):
        dev = MockDevice()
        with pytest.raises(RuntimeError):
            dev.read(100)
        dev.activate_stream()
        assert dev.read(100).shape == (100,)

    def test_replay_and_eos(self):
        samples = np.arange(1000).astype(np.complex64)
        dev = MockDevice(samples=samples)
        dev.activate_stream()
        a = dev.read(600)
        b = dev.read(600)
        assert dev.read(1) is None
        np.testing.assert_array_equal(np.concatenate([a, b]), samples)

    def test_factory_unknown_driver(self):
        with pytest.raises(ValueError, match="unknown SDR driver"):
            open_device("notareal_sdr")

    def test_soapy_unavailable_raises_helpfully(self):
        with pytest.raises(RuntimeError, match="SoapySDR"):
            open_device("rtlsdr")

    def test_soapy_glue_with_fake_module(self, monkeypatch):
        """Exercise the SoapyDevice configure/stream/read paths with a
        fake ``SoapySDR`` module injected into sys.modules — the
        reference's MockDevice pattern one layer down
        (src/sdr_mock/device_mock.rs:7-69 substitutes the SoapySDR
        device behind the same trait)."""
        calls = []

        class _FakeStreamResult:
            def __init__(self, ret):
                self.ret = ret

        class _FakeSoapyDev:
            def __init__(self, args):
                calls.append(("ctor", dict(args)))
                self._rng = np.random.default_rng(7)

            def __str__(self):
                return "FakeRTL v1"

            def setFrequency(self, direction, chan, hz):
                calls.append(("freq", hz))

            def setSampleRate(self, direction, chan, hz):
                calls.append(("rate", hz))

            def setGain(self, direction, chan, db):
                calls.append(("gain", db))

            def setupStream(self, direction, fmt):
                calls.append(("setup", fmt))
                return "stream-handle"

            def activateStream(self, stream):
                calls.append(("activate", stream))

            def readStream(self, stream, bufs, n, timeoutUs=0):
                bufs[0][:n] = (self._rng.standard_normal(n)
                               + 1j * self._rng.standard_normal(n)
                               ).astype(np.complex64)
                return _FakeStreamResult(n)

        fake = types.ModuleType("SoapySDR")
        fake.SOAPY_SDR_RX = 1
        fake.SOAPY_SDR_CF32 = "CF32"
        fake.Device = _FakeSoapyDev
        monkeypatch.setitem(sys.modules, "SoapySDR", fake)

        dev = open_device("rtlsdr", args="serial=0001,tuner=R820T")
        assert dev.info.driver == "rtlsdr"
        assert dev.info.label == "FakeRTL v1"
        assert ("ctor", {"driver": "rtlsdr", "serial": "0001",
                         "tuner": "R820T"}) in calls

        # the reference's JSON config keys flow through to the device
        dev.configure(json.dumps({
            "center_freq_hz": 1_575_420_000.0,
            "sample_rate_hz": 2_048_000.0,
            "gain_db": 30.0,
        }))
        dev.activate_stream()
        assert ("freq", 1_575_420_000.0) in calls
        assert ("rate", 2_048_000.0) in calls
        assert ("gain", 30.0) in calls
        assert ("setup", "CF32") in calls
        assert ("activate", "stream-handle") in calls

        out = dev.read(4096)
        assert out.shape == (4096,) and out.dtype == np.complex64

    def test_soapy_short_read_and_eos(self, monkeypatch):
        """readStream returning fewer samples (or an error code) maps to
        a short array / None exactly like the file sources."""
        class _Res:
            def __init__(self, ret):
                self.ret = ret

        class _Dev:
            def __init__(self, args):
                self.reads = 0

            def __str__(self):
                return "short"

            def setFrequency(self, *a):
                pass

            def setSampleRate(self, *a):
                pass

            def setGain(self, *a):
                pass

            def setupStream(self, *a):
                return 0

            def activateStream(self, s):
                pass

            def readStream(self, stream, bufs, n, timeoutUs=0):
                self.reads += 1
                if self.reads == 1:
                    bufs[0][: n // 2] = 1.0 + 0j
                    return _Res(n // 2)
                return _Res(-1)   # SOAPY_SDR_TIMEOUT-style error

        fake = types.ModuleType("SoapySDR")
        fake.SOAPY_SDR_RX = 1
        fake.SOAPY_SDR_CF32 = "CF32"
        fake.Device = _Dev
        monkeypatch.setitem(sys.modules, "SoapySDR", fake)

        dev = open_device("hackrf")
        dev.set_center_frequency(1.57542e9)
        dev.set_sample_rate(2.048e6)
        dev.activate_stream()
        first = dev.read(1000)
        assert first.shape == (500,)
        assert dev.read(1000) is None

    def test_device_feeds_receiver(self):
        """MockDevice as a Receiver source (the reference's hardware-mock
        pattern, SURVEY.md section 4)."""
        from gnss_sdr.config import ReceiverConfig, RfConfig, TrackConfig
        from gnss_sdr.receiver import Receiver

        fs = 2_048_000.0
        sig = synthesize(
            [SatelliteScenario(prn=13, doppler_hz=-700.0, amplitude=0.3)],
            int(0.3 * fs), fs, noise_std=1.0, seed=6,
        )
        dev = MockDevice(samples=sig)
        dev.set_sample_rate(fs)
        dev.activate_stream()
        rx = Receiver(
            ReceiverConfig(rf=RfConfig(freq_if_hz=0.0,
                                       output_sample_rate_hz=fs),
                           track=TrackConfig(n_channels=4), block_ms=20),
            dev,
        )
        out = rx.run()
        assert out["tracked_prns"] == [13]
