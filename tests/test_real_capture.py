"""Real-capture integration tests keyed to the reference's bundled
ground truth (reference: src/test_data/GPS_recordings/config.txt).

The IQ blob (gioveAandB_short.bin) is absent from the mounted reference
(.MISSING_LARGE_BLOBS); these tests skip gracefully when it cannot be
found — the same policy as the reference's own tests
(do_acquisition.rs:412-418). Drop the capture at either path below (or
set GNSS_CAPTURE_PATH) to activate them.
"""
import os

import numpy as np
import pytest

CANDIDATE_PATHS = [
    os.environ.get("GNSS_CAPTURE_PATH", ""),
    "/root/reference/src/test_data/GPS_recordings/gioveAandB_short.bin",
    "/root/repo/test_data/gioveAandB_short.bin",
]
CAPTURE = next((p for p in CANDIDATE_PATHS if p and os.path.exists(p)), None)

FS = 16_367_600.0
F_IF = 4_130_400.0

# config.txt truth table: PRN -> (carrier freq Hz, code phase samples)
TRUTH = {
    2: (4_128_460.0, 15042),
    3: (4_127_190.0, 1618),
    19: (4_129_280.0, 6184),
    14: (4_133_130.0, 14540),
    18: (4_127_310.0, 344),
    11: (4_133_280.0, 2955),
    32: (4_134_060.0, 6857),
    6: (4_127_220.0, 7828),
    28: (4_132_022.0, 15203),
    9: (4_132_420.0, 9437),
}

pytestmark = pytest.mark.skipif(
    CAPTURE is None,
    reason="real capture blob absent (missing from the mounted reference; "
    "see .MISSING_LARGE_BLOBS) — set GNSS_CAPTURE_PATH to enable",
)


@pytest.fixture(scope="module")
def capture_samples():
    raw = np.fromfile(CAPTURE, dtype=np.int8, count=int(0.2 * FS))
    return raw.astype(np.float32).astype(np.complex64)


class TestRealCaptureAcquisition:
    def test_acquired_set_is_subset_of_truth(self, capture_samples):
        """Reference gate (do_acquisition.rs:454): every acquired PRN
        must be in the known visible set."""
        from gnss_sdr.models import GPS_L1CA
        from gnss_sdr.ops import pcps

        n = GPS_L1CA.samples_per_code(FS)
        x = capture_samples[: 10 * n]
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0) + np.float32(F_IF)
        res = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=10)
        acquired = set((np.where(np.asarray(res.detected))[0] + 1).tolist())
        assert acquired, "no satellites acquired from the real capture"
        assert acquired <= set(TRUTH), f"false acquisitions: {acquired - set(TRUTH)}"
        # the strong satellites must all be found
        assert {2, 3, 19, 18, 6} <= acquired
        # carrier frequencies within one Doppler bin of truth
        for prn in acquired:
            got = float(res.carrier_freq_hz[prn - 1])
            assert abs(got - TRUTH[prn][0]) <= 300.0, f"PRN {prn}"

    def test_code_phases_match_truth(self, capture_samples):
        from gnss_sdr.models import GPS_L1CA
        from gnss_sdr.ops import pcps

        n = GPS_L1CA.samples_per_code(FS)
        x = capture_samples[: 10 * n]
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0) + np.float32(F_IF)
        res = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=10)
        det = np.asarray(res.detected)
        for prn, (_, truth_cp) in TRUTH.items():
            if not det[prn - 1]:
                continue
            got = int(res.code_phase_samples[prn - 1])
            # truth code phases are quoted modulo one code period
            diff = min(abs(got - truth_cp), n - abs(got - truth_cp))
            assert diff <= 3, f"PRN {prn}: {got} vs {truth_cp}"


class TestRealCaptureTracking:
    def test_track_100_epochs(self, capture_samples):
        """Reference gate (do_tracking.rs:725-746): hold lock for 100
        consecutive epochs on the real capture via the full receiver."""
        from gnss_sdr.config import (
            AcqConfig,
            ReceiverConfig,
            RfConfig,
            TrackConfig,
        )
        from gnss_sdr.receiver import ArraySource, Receiver

        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=F_IF, output_sample_rate_hz=FS,
                        enable_mixing=True, enable_dc_removal=True),
            acq=AcqConfig(),
            track=TrackConfig(n_channels=12),
            block_ms=20,
        )
        rx = Receiver(cfg, ArraySource(capture_samples, FS))
        rx.run()
        assert set(rx.active) <= set(TRUTH)
        assert len(rx.active) >= 4
        for trace in rx.telemetry.all_traces():
            if trace.prn not in rx.active:
                continue
            power = np.asarray(trace.i_p) ** 2 + np.asarray(trace.q_p) ** 2
            assert power.size >= 100
            assert (power[-100:] > cfg.track.lock_threshold).all(), (
                f"PRN {trace.prn} lost lock on real capture"
            )
