"""In-scan acquisition: the steady-state paced re-search runs INSIDE
the multi-block span program (FusedTracker.span_extra -> engine
conv_search_device), so it costs zero extra host round trips. A
satellite that rises AFTER the constellation reaches steady mode must
still be acquired — from the span program's own search output."""
import numpy as np
import pytest

from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario, synthesize
from gnss_sdr.receiver import ArraySource, Receiver

FS = 2_046_000.0


def _rising_scene():
    """PRNs 3 and 7 from t=0; PRN 4 rises at t=0.24 s.

    The riser must sit within the steady scheduler's candidate window
    (the FIRST search_size untracked PRNs, reference semantics
    do_acquisition.rs:65-68) or no steady re-search would ever try it.
    Amplitudes at the live-test operating point (0.3 vs noise 1.0):
    stronger signals raise code cross-correlation ghosts above the
    ratio threshold."""
    base = [SatelliteScenario(prn=3, doppler_hz=700.0, amplitude=0.3),
            SatelliteScenario(prn=7, doppler_hz=-450.0, amplitude=0.3)]
    rise = base + [SatelliteScenario(prn=4, doppler_hz=1300.0,
                                     amplitude=0.3)]
    n1 = int(0.24 * FS)
    n2 = int(1.0 * FS)
    a = synthesize(base, n1, FS, noise_std=1.0, seed=8)
    b = synthesize(rise, n2 - n1, FS, noise_std=1.0, seed=9,
                   start_sample=n1)
    return np.concatenate([a, b])


class TestInScanAcquisition:
    def test_rising_satellite_acquired_in_span(self):
        sig = _rising_scene()
        rx = Receiver(
            ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(engine="conv", steady_threshold=2,
                              steady_pacing=(200, 8)),
                track=TrackConfig(n_channels=4, correlator="fused"),
                block_ms=20,
            ),
            ArraySource(sig, FS),
        )
        assert rx._span_acq, "conv engine + fused step must arm " \
            "the in-scan search"
        rx.run(scan_blocks=4)
        # the rising satellite was found by the in-scan paced search
        # (steady mode from block ~2; PRN 4 rises at 0.24 s, well
        # after spans begin)
        assert 4 in rx.active and 3 in rx.active and 7 in rx.active
        assert rx.fused.last_span_extra is not None
        rise_events = [e for e in rx.acq_events if e[1].prn == 4]
        assert rise_events and rise_events[0][0] >= 240.0

    def test_cpu_fft_engine_not_armed(self):
        rx = Receiver(
            ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(),      # auto -> fft on CPU
                track=TrackConfig(n_channels=2, correlator="fused"),
                block_ms=20,
            ),
            ArraySource(synthesize(
                [SatelliteScenario(prn=3, doppler_hz=700.0)],
                int(0.1 * FS), FS, noise_std=0.5, seed=8), FS),
        )
        assert not rx._span_acq
