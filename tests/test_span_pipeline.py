"""Pipelined steady-state spans (Receiver.run(span_pipeline=True)):
the span ledger chains ON DEVICE (FusedTracker.submit_span /
handle.led), telemetry downloads trail by one span, and in-scan
acquisition handoffs apply as device ledger updates one span late.

Tracking OUTCOME must match the synchronous span path; the documented
semantic differences are bounded (handoff latency one span, lifecycle
bookkeeping one span)."""
import numpy as np

from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario, synthesize
from gnss_sdr.receiver import ArraySource, Receiver

FS = 2_046_000.0


def _rx(sig, **acq_kw):
    return Receiver(
        ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(engine="conv", steady_threshold=2, **acq_kw),
            track=TrackConfig(n_channels=4, correlator="fused"),
            block_ms=20,
        ),
        ArraySource(sig, FS),
    )


class TestSpanPipeline:
    def test_matches_synchronous_spans(self):
        sig = synthesize(
            [SatelliteScenario(prn=3, doppler_hz=700.0, amplitude=0.3),
             SatelliteScenario(prn=7, doppler_hz=-450.0, amplitude=0.3)],
            int(0.8 * FS), FS, noise_std=1.0, seed=8)

        rx_a = _rx(sig)
        s_a = rx_a.run(scan_blocks=4)
        rx_b = _rx(sig)
        s_b = rx_b.run(scan_blocks=4, span_pipeline=True)

        assert s_b["tracked_prns"] == s_a["tracked_prns"] == [3, 7]
        assert s_b["blocks"] == s_a["blocks"]
        ch_a = {c["prn"]: c for c in s_a["channels"]}
        ch_b = {c["prn"]: c for c in s_b["channels"]}
        for prn in (3, 7):
            assert abs(ch_b[prn]["last_doppler_hz"]
                       - ch_a[prn]["last_doppler_hz"]) < 5.0
            assert ch_b[prn]["locked_fraction"] > 0.95
            # the pipelined path must process every epoch the
            # synchronous path does
            assert abs(ch_b[prn]["epochs"] - ch_a[prn]["epochs"]) <= 1
        # host ledger synced at pipeline exit: exact integer fields
        np.testing.assert_array_equal(
            np.asarray(rx_b.state.active)[:2],
            np.asarray(rx_a.state.active)[:2])

    def test_rising_satellite_handoff_through_device_ledger(self):
        from test_span_acq import _rising_scene

        sig = _rising_scene()
        rx = _rx(sig, steady_pacing=(200, 8))
        s = rx.run(scan_blocks=4, span_pipeline=True)
        # PRN 4 rises at 0.24 s; the pipelined in-scan search must
        # acquire it THROUGH apply_handoffs_device (one span late)
        assert 4 in rx.active, s["tracked_prns"]
        ch = [c for c in s["channels"] if c["prn"] == 4][0]
        assert abs(ch["last_doppler_hz"] - 1300.0) < 60
        rise = [e for e in rx.acq_events if e[1].prn == 4]
        assert rise and rise[0][0] >= 240.0

    def test_pvt_survives_pipeline(self):
        """Nav/observables consume the pipelined telemetry identically
        (epoch indexing, chip phases) — the nav status after a
        pipelined run matches the synchronous run."""
        sig = synthesize(
            [SatelliteScenario(prn=3, doppler_hz=700.0, amplitude=0.3),
             SatelliteScenario(prn=7, doppler_hz=-450.0, amplitude=0.3)],
            int(0.6 * FS), FS, noise_std=1.0, seed=9)
        rx_a = _rx(sig)
        rx_a.run(scan_blocks=4)
        rx_b = _rx(sig)
        rx_b.run(scan_blocks=4, span_pipeline=True)
        st_a = {v["prn"]: v["bit_synced"]
                for v in rx_a.summary()["nav"].values()}
        st_b = {v["prn"]: v["bit_synced"]
                for v in rx_b.summary()["nav"].values()}
        assert st_b == st_a
