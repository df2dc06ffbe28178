"""Multi-constellation receiver: GPS + Galileo + GLONASS-FDMA over one
shared stream (BASELINE.md config ladder 4)."""
import numpy as np
import pytest

from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import (
    BEIDOU_B1I,
    GALILEO_E1B,
    GLONASS_L1OF,
    GPS_L1CA,
    SatelliteScenario,
)
from gnss_sdr.receiver import (
    MultiConstellationReceiver,
    Receiver,
    SyntheticSource,
    TeeSource,
    ArraySource,
)

FS = 8_184_000.0


class TestTeeSource:
    def test_branches_see_identical_stream(self):
        data = (np.arange(10_000) + 1j).astype(np.complex64)
        tee = TeeSource(ArraySource(data, 1e6), 2)
        a, b = tee.branch(0), tee.branch(1)
        got_a = [a.read(3000) for _ in range(5)]
        got_b = [b.read(5000) for _ in range(4)]
        ca = np.concatenate([g for g in got_a if g is not None])
        cb = np.concatenate([g for g in got_b if g is not None])
        np.testing.assert_array_equal(ca, data)
        np.testing.assert_array_equal(cb, data)

    def test_eos_propagates(self):
        tee = TeeSource(ArraySource(np.zeros(100, np.complex64), 1e6), 2)
        b = tee.branch(0)
        assert b.read(100).size == 100
        assert b.read(10) is None


class TestMultiConstellation:
    def test_gps_galileo_glonass_together(self):
        gps_sats = [
            SatelliteScenario(prn=4, doppler_hz=2100.0, amplitude=0.22,
                              signal=GPS_L1CA),
            SatelliteScenario(prn=29, doppler_hz=-3600.0, amplitude=0.2,
                              code_phase_chips=400.0, signal=GPS_L1CA),
        ]
        gal_sats = [
            SatelliteScenario(prn=11, doppler_hz=1500.0, amplitude=0.17,
                              signal=GALILEO_E1B),
        ]
        glo_sats = [
            # FDMA channel +2 with -1200 Hz doppler
            SatelliteScenario(prn=1, doppler_hz=2 * 562_500.0 - 1200.0,
                              amplitude=0.3, signal=GLONASS_L1OF),
        ]
        bds_sats = [
            SatelliteScenario(prn=27, doppler_hz=-900.0, amplitude=0.3,
                              signal=BEIDOU_B1I),
        ]
        source = SyntheticSource(
            gps_sats + gal_sats + glo_sats + bds_sats, FS, noise_std=1.0,
            seed=13, total_samples=int(0.5 * FS),
        )
        configs = {
            "gps_l1ca": ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(signal="gps_l1ca"),
                track=TrackConfig(signal="gps_l1ca", n_channels=8),
                block_ms=20,
            ),
            "galileo_e1b": ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                # 4 ms codes need a higher peak/avg operating point and
                # more integration to reject cross-correlation floors
                acq=AcqConfig(signal="galileo_e1b", n_prn=36,
                              non_coherent_ms=16, detection_threshold=12.0),
                track=TrackConfig(signal="galileo_e1b", n_channels=4),
                block_ms=20,
            ),
            "glonass_l1of": ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(signal="glonass_l1of", n_prn=14,
                              fdma_spacing_hz=562_500.0,
                              fdma_channels=tuple(range(-7, 7))),
                track=TrackConfig(signal="glonass_l1of", n_channels=4),
                block_ms=20,
            ),
            "beidou_b1i": ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(signal="beidou_b1i", n_prn=37,
                              detection_threshold=10.0),
                track=TrackConfig(signal="beidou_b1i", n_channels=16),
                block_ms=20,
            ),
        }
        # config ladder 4: 32 channels total across 4 constellations
        assert sum(c.track.n_channels for c in configs.values()) == 32
        mrx = MultiConstellationReceiver(configs, source)
        out = mrx.run()

        assert out["gps_l1ca"]["tracked_prns"] == [4, 29]
        assert out["galileo_e1b"]["tracked_prns"] == [11]
        # FDMA channel +2 is at index 9 of range(-7,7) -> pseudo-PRN 10
        assert out["glonass_l1of"]["tracked_prns"] == [10]
        assert out["beidou_b1i"]["tracked_prns"] == [27]

        # all constellations hold lock with correct doppler
        gps = {c["prn"]: c for c in out["gps_l1ca"]["channels"]}
        assert gps[4]["last_doppler_hz"] == pytest.approx(2100.0, abs=10.0)
        assert gps[29]["last_doppler_hz"] == pytest.approx(-3600.0, abs=10.0)
        gal = out["galileo_e1b"]["channels"][0]
        assert gal["locked_fraction"] > 0.9
        assert gal["last_doppler_hz"] == pytest.approx(1500.0, abs=10.0)
        glo = out["glonass_l1of"]["channels"][0]
        assert glo["last_doppler_hz"] == pytest.approx(
            2 * 562_500.0 - 1200.0, abs=10.0
        )
        bds = out["beidou_b1i"]["channels"][0]
        assert bds["locked_fraction"] > 0.9
        assert bds["last_doppler_hz"] == pytest.approx(-900.0, abs=10.0)
