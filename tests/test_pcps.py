"""PCPS acquisition tests.

Strategy mirrors the reference's acquisition tests
(reference: src/acquisition/do_acquisition.rs:398-466) but uses the
synthetic oracle (the bundled real capture is absent upstream,
.MISSING_LARGE_BLOBS) with known Doppler/code-phase truth per satellite.
"""
import numpy as np
import pytest

from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.ops import pcps

FS = 4_096_000.0
N = GPS_L1CA.samples_per_code(FS)  # 4096
N_INT = 10


def _search(sats, f_if=0.0, noise=0.0, threshold=7.0, n_prn=32, seed=0):
    x = synthesize(sats, N_INT * N, FS, f_if_hz=f_if, noise_std=noise, seed=seed)
    code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, n_prn)
    grid = pcps.doppler_grid(14_000.0, 500.0) + np.float32(f_if)
    return pcps.pcps_search(
        x, code_ffts, grid, fs_hz=FS, n_int=N_INT, threshold=threshold
    )


class TestPcpsSearch:
    def test_single_satellite_detection(self):
        # noise matters: in a noiseless scene even cross-correlation floors
        # pass the peak/avg test (the reference's detector statistic has
        # the same property; its tests used noisy captures)
        true_doppler, true_cp_chips = 2500.0, 333.0
        res = _search(
            [SatelliteScenario(prn=7, doppler_hz=true_doppler,
                               code_phase_chips=true_cp_chips,
                               amplitude=0.2)],
            noise=1.0,
        )
        det = np.asarray(res.detected)
        assert det[6], "PRN 7 must be detected"
        assert det.sum() == 1, f"only PRN 7 should pass, got {np.where(det)[0]+1}"
        assert float(res.carrier_freq_hz[6]) == pytest.approx(true_doppler, abs=250.0)
        # signal starting at code phase c appears at lag (1023-c) * fs/rate
        expected_lag = round((1023 - true_cp_chips) * FS / 1.023e6) % N
        assert abs(int(res.code_phase_samples[6]) - expected_lag) <= 2

    def test_multi_satellite_with_noise(self):
        sats = [
            SatelliteScenario(prn=3, doppler_hz=-4000.0, code_phase_chips=10.0,
                              amplitude=0.30),
            SatelliteScenario(prn=18, doppler_hz=1000.0, code_phase_chips=500.0,
                              amplitude=0.25),
            SatelliteScenario(prn=28, doppler_hz=6500.0, code_phase_chips=900.0,
                              amplitude=0.35),
        ]
        res = _search(sats, noise=1.0, seed=1)
        det = set((np.where(np.asarray(res.detected))[0] + 1).tolist())
        assert det == {3, 18, 28}

    def test_no_signal_no_detection(self):
        res = _search([], noise=1.0, seed=2)
        assert not np.any(np.asarray(res.detected))

    def test_detection_at_if(self):
        # real-capture style: satellites ride on a nonzero IF
        f_if = 1_000_000.0
        res = _search(
            [SatelliteScenario(prn=11, doppler_hz=-2000.0, amplitude=0.25)],
            f_if=f_if, noise=1.0,
        )
        assert np.asarray(res.detected)[10]
        assert float(res.carrier_freq_hz[10]) == pytest.approx(
            f_if - 2000.0, abs=250.0
        )

    def test_weak_satellite_needs_integration(self):
        # Non-coherent integration gain (reference rationale for
        # LONG_SAMPLES_LENGTH=10, do_acquisition.rs:23): the mean peak/avg
        # statistic is ~constant in integration count, but noise peaks
        # regress toward the mean, so false-alarm ratios on absent PRNs
        # shrink while the true satellite stays detected.
        sat = [SatelliteScenario(prn=22, doppler_hz=3000.0, amplitude=0.14)]
        x = synthesize(sat, N_INT * N, FS, noise_std=1.0, seed=3)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        res10 = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=N_INT)
        res1 = pcps.pcps_search(x[:N], code_ffts, grid, fs_hz=FS, n_int=1)
        assert np.asarray(res10.detected)[21]
        absent = np.arange(32) != 21
        fa10 = float(np.max(np.asarray(res10.ratio)[absent]))
        fa1 = float(np.max(np.asarray(res1.ratio)[absent]))
        assert fa10 < fa1
        assert fa10 < 7.0

    def test_ratio_statistic_matches_definition(self):
        res = _search(
            [SatelliteScenario(prn=1, doppler_hz=0.0, amplitude=0.3)],
            noise=1.0, threshold=7.0,
        )
        assert float(res.ratio[0]) > 7.0
        assert float(res.peak_power[0]) > 0.0

    def test_wrong_length_raises(self):
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 2)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        with pytest.raises(ValueError):
            pcps.pcps_search(
                np.zeros(123, np.complex64), code_ffts, grid,
                fs_hz=FS, n_int=N_INT,
            )


class TestFineDoppler:
    def test_refines_within_bin(self):
        true_doppler = 2130.0  # 120 Hz off the 2000 Hz grid point
        sats = [SatelliteScenario(prn=9, doppler_hz=true_doppler)]
        x = synthesize(sats, N_INT * N, FS, noise_std=0.5, seed=4)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        res = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=N_INT)
        assert np.asarray(res.detected)[8]
        coarse = float(res.carrier_freq_hz[8])
        assert abs(coarse - true_doppler) <= 250.0

        codes = np.stack(
            [GPS_L1CA.sample_code(p, 1.023e6, FS) for p in range(1, 33)]
        ).astype(np.float32)
        fine = pcps.fine_doppler(
            x, codes, res.code_phase_samples, res.carrier_freq_hz,
            fs_hz=FS, n_int=N_INT, zero_pad=8,
        )
        refined = float(fine[8])
        assert abs(refined - true_doppler) < 30.0
        assert abs(refined - true_doppler) < abs(coarse - true_doppler)


class TestDetectorModes:
    """Legacy-reference detector parity (acquisition_bk.rs:306-399)."""

    def _scene(self):
        sats = [SatelliteScenario(prn=7, doppler_hz=2500.0, amplitude=0.2)]
        x = synthesize(sats, N_INT * N, FS, noise_std=1.0, seed=0)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        return x, code_ffts, grid

    def test_two_peak(self):
        x, cf, grid = self._scene()
        excl = round(1.0 * FS / 1.023e6)
        res = pcps.pcps_search(
            x, cf, grid, fs_hz=FS, n_int=N_INT, threshold=1.4,
            mode="two_peak", exclusion_samples=excl,
        )
        det = np.asarray(res.detected)
        ratios = np.asarray(res.ratio)
        # the legacy two-peak detector at threshold 1.4 admits isolated
        # cross-correlation peaks (false alarms) — faithful legacy
        # behavior; the true satellite must dominate decisively
        assert det[6]
        assert np.argmax(ratios) == 6
        assert ratios[6] > 2.0 * np.partition(ratios, -2)[-2]

    def test_cfar(self):
        x, cf, grid = self._scene()
        res = pcps.pcps_search(
            x, cf, grid, fs_hz=FS, n_int=N_INT, threshold=5.988,
            mode="cfar",
        )
        det = np.asarray(res.detected)
        assert det[6] and det.sum() == 1

    def test_engine_wires_detector(self):
        from gnss_sdr.config import AcqConfig
        from gnss_sdr.models import GPS_L1CA as spec
        from gnss_sdr.receiver.acquisition import AcquisitionEngine

        x, _, _ = self._scene()
        eng = AcquisitionEngine(
            AcqConfig(detector="two_peak"), spec, FS, 0.0
        )
        cands = eng.search(np.asarray(x))
        # candidates sort by ratio: the true satellite ranks first
        assert cands[0].prn == 7


class TestPaddedFft:
    """Power-of-two linear-correlation PCPS path vs the circular path."""

    def test_matches_circular_detection(self):
        sats = [
            SatelliteScenario(prn=7, doppler_hz=2500.0,
                              code_phase_chips=333.0, amplitude=0.2),
            SatelliteScenario(prn=21, doppler_hz=-4250.0,
                              code_phase_chips=80.0, amplitude=0.25),
        ]
        x = synthesize(sats, (N_INT + 1) * N, FS, noise_std=1.0, seed=6)
        grid = pcps.doppler_grid(14_000.0, 500.0)

        circ = pcps.pcps_search(
            x[: N_INT * N], pcps.code_replica_ffts(GPS_L1CA, FS, 32),
            grid, fs_hz=FS, n_int=N_INT,
        )
        padded_codes = pcps.code_replica_ffts_padded(GPS_L1CA, FS, 32)
        assert padded_codes.shape[-1] == 8192  # next_pow2(2*4096)
        lin = pcps.pcps_search(
            x, padded_codes, grid, fs_hz=FS, n_int=N_INT,
            pad_fft=True, n_fft=N,
        )
        det_c = set(np.where(np.asarray(circ.detected))[0] + 1)
        det_l = set(np.where(np.asarray(lin.detected))[0] + 1)
        assert det_l == det_c == {7, 21}
        for prn in (7, 21):
            assert abs(
                int(circ.code_phase_samples[prn - 1])
                - int(lin.code_phase_samples[prn - 1])
            ) <= 1
            assert float(circ.carrier_freq_hz[prn - 1]) == float(
                lin.carrier_freq_hz[prn - 1]
            )

    def test_receiver_with_pad_fft(self):
        from gnss_sdr.config import (
            AcqConfig, ReceiverConfig, RfConfig, TrackConfig,
        )
        from gnss_sdr.receiver import Receiver, SyntheticSource

        src = SyntheticSource(
            [SatelliteScenario(prn=14, doppler_hz=-1300.0, amplitude=0.25)],
            FS, noise_std=1.0, seed=8, total_samples=int(0.3 * FS),
        )
        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(pad_fft=True),
            track=TrackConfig(n_channels=4),
            block_ms=20,
        )
        rx = Receiver(cfg, src)
        out = rx.run()
        assert out["tracked_prns"] == [14]


class TestCoherentIntegration:
    def test_coherent_gain_detects_weak_satellite(self):
        """A satellite too weak for 10x1 ms non-coherent integration is
        detected with 2x5 ms coherent groups over the same capture."""
        true_doppler = 2000.0  # exactly on a 500 Hz grid point
        sat = [SatelliteScenario(prn=13, doppler_hz=true_doppler,
                                 amplitude=0.035)]
        x = synthesize(sat, N_INT * N, FS, noise_std=1.0, seed=11)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)

        plain = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=N_INT)
        coh = pcps.pcps_search(
            x, code_ffts, grid, fs_hz=FS, n_int=N_INT, coherent=5
        )
        assert not bool(plain.detected[12]), (
            f"scene too strong: plain ratio {float(plain.ratio[12]):.1f}"
        )
        assert bool(coh.detected[12]), (
            f"coherent ratio {float(coh.ratio[12]):.1f}"
        )
        assert float(coh.ratio[12]) > 2.0 * float(plain.ratio[12])

    def test_indivisible_raises(self):
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 2)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        x = np.zeros(N_INT * N, np.complex64)
        with pytest.raises(ValueError, match="divisible"):
            pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=N_INT,
                             coherent=3)


class TestConvPcps:
    """FFT-free conv/matmul acquisition (the in-span search engine)."""

    def test_matches_fft_path(self):
        sats = [
            SatelliteScenario(prn=7, doppler_hz=2500.0,
                              code_phase_chips=333.0, amplitude=0.2),
            SatelliteScenario(prn=19, doppler_hz=-3750.0, amplitude=0.25),
        ]
        x = synthesize(sats, (N_INT + 1) * N, FS, noise_std=1.0, seed=9)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        fft_res = pcps.pcps_search(
            x[: N_INT * N], pcps.code_replica_ffts(GPS_L1CA, FS, 32),
            grid, fs_hz=FS, n_int=N_INT,
        )
        codes = np.stack([
            GPS_L1CA.sample_code(p, 1.023e6, FS) for p in range(1, 33)
        ]).astype(np.float32)
        conv_res = pcps.pcps_search_conv(
            np.real(x).astype(np.float32), np.imag(x).astype(np.float32),
            codes, grid, fs_hz=FS, n_int=N_INT,
        )
        det_f = set(np.where(np.asarray(fft_res.detected))[0] + 1)
        det_c = set(np.where(np.asarray(conv_res.detected))[0] + 1)
        assert det_c == det_f == {7, 19}
        for prn in (7, 19):
            assert abs(int(conv_res.code_phase_samples[prn - 1])
                       - int(fft_res.code_phase_samples[prn - 1])) <= 1
            assert float(conv_res.carrier_freq_hz[prn - 1]) == float(
                fft_res.carrier_freq_hz[prn - 1]
            )


class TestConvEngineReceiver:
    def test_engine_conv_full_receiver(self):
        """AcquisitionEngine engine='conv' + fine_doppler_conv +
        correlator='fused': the in-span search receiver stack,
        exercised end to end on CPU."""
        from gnss_sdr.config import (AcqConfig, ReceiverConfig,
                                         RfConfig, TrackConfig)
        from gnss_sdr.receiver import Receiver, SyntheticSource

        fs = 2_046_000.0
        scen = [SatelliteScenario(prn=4, doppler_hz=2222.0,
                                  amplitude=0.3),
                SatelliteScenario(prn=19, doppler_hz=-987.0,
                                  amplitude=0.3)]
        src = SyntheticSource(scen, fs, noise_std=1.0, seed=21)
        rx = Receiver(ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
            acq=AcqConfig(engine="conv"),
            track=TrackConfig(n_channels=4, correlator="fused"),
            block_ms=20), src)
        out = rx.run(max_blocks=22)
        assert out["tracked_prns"] == [4, 19]
        for ch in out["channels"]:
            truth = {4: 2222.0, 19: -987.0}[ch["prn"]]
            # fine_doppler_conv must land inside the Costas pull-in
            assert abs(ch["last_doppler_hz"] - truth) < 8.0

    def test_acquire_conv_coarse_to_fine_matches_full_rate(self):
        """decim=2 coarse search + full-rate lag refinement must agree
        with the decim=1 full-rate search on lag and Doppler — including
        boundary code phases where the refinement window wraps."""
        grid = pcps.doppler_grid(14_000.0, 500.0)
        codes = np.stack([
            GPS_L1CA.sample_code(p, 1.023e6, FS) for p in range(1, 33)
        ]).astype(np.float32)
        coarse_codes = codes.reshape(32, N // 2, 2).mean(-1)
        sel = np.eye(32, dtype=np.float32)
        # code phases chosen so full-rate lags land near 0, near N-1
        # (refinement wrap), and mid-range
        sats = [
            SatelliteScenario(prn=5, doppler_hz=3210.0,
                              code_phase_chips=1022.8, amplitude=0.3),
            SatelliteScenario(prn=12, doppler_hz=-1789.0,
                              code_phase_chips=0.2, amplitude=0.3),
            SatelliteScenario(prn=30, doppler_hz=555.0,
                              code_phase_chips=500.0, amplitude=0.3),
        ]
        x = synthesize(sats, (N_INT + 1) * N, FS, noise_std=1.0, seed=13)
        re = np.real(x).astype(np.float32)
        im = np.imag(x).astype(np.float32)
        kw = dict(fs_hz=FS, n_int=N_INT, threshold=7.0)
        full = pcps.acquire_conv(re, im, codes, codes, sel, grid,
                                 decim=1, **kw)
        c2f = pcps.acquire_conv(re, im, codes, coarse_codes, sel, grid,
                                decim=2, **kw)
        want = {5, 12, 30}
        assert set(np.where(np.asarray(full.detected))[0] + 1) == want
        assert set(np.where(np.asarray(c2f.detected))[0] + 1) == want
        for prn in want:
            lag_full = int(full.code_phase_samples[prn - 1])
            lag_c2f = int(c2f.code_phase_samples[prn - 1])
            d = abs(lag_full - lag_c2f)
            assert min(d, N - d) <= 1, (prn, lag_full, lag_c2f)
            assert float(c2f.carrier_freq_hz[prn - 1]) == pytest.approx(
                float(full.carrier_freq_hz[prn - 1]), abs=20.0)

    def test_acquire_conv_prn_bucketing(self):
        """A selection matrix restricting the search to a candidate
        subset returns the same verdicts on the selected rows; zero pad
        rows never detect."""
        grid = pcps.doppler_grid(14_000.0, 500.0)
        codes = np.stack([
            GPS_L1CA.sample_code(p, 1.023e6, FS) for p in range(1, 33)
        ]).astype(np.float32)
        sats = [SatelliteScenario(prn=9, doppler_hz=-2500.0,
                                  code_phase_chips=700.0, amplitude=0.3)]
        x = synthesize(sats, (N_INT + 1) * N, FS, noise_std=1.0, seed=14)
        re = np.real(x).astype(np.float32)
        im = np.imag(x).astype(np.float32)
        # bucket of 4: PRNs {9, 17, 23} + one zero pad row
        sel = np.zeros((4, 32), np.float32)
        for i, p in enumerate((9, 17, 23)):
            sel[i, p - 1] = 1.0
        res = pcps.acquire_conv(re, im, codes, codes, sel, grid,
                                fs_hz=FS, n_int=N_INT, decim=1,
                                threshold=7.0)
        det = np.asarray(res.detected)
        assert det.tolist() == [True, False, False, False]
        full_sel = np.eye(32, dtype=np.float32)
        full = pcps.acquire_conv(re, im, codes, codes, full_sel, grid,
                                 fs_hz=FS, n_int=N_INT, decim=1,
                                 threshold=7.0)
        assert int(res.code_phase_samples[0]) == int(
            full.code_phase_samples[8])
        assert float(res.carrier_freq_hz[0]) == float(
            full.carrier_freq_hz[8])

    def test_engine_auto_decim_and_bucketed_search(self):
        """AcquisitionEngine auto-picks the largest decimation keeping
        >= 1 sample/chip and the bucketed conv search still finds the
        satellite with a correct window-relative boundary index."""
        from gnss_sdr.config import AcqConfig
        from gnss_sdr.receiver.acquisition import AcquisitionEngine

        fs = 4_092_000.0
        spec = GPS_L1CA
        eng = AcquisitionEngine(AcqConfig(engine="conv"), spec, fs, 0.0)
        assert eng.decim == 4  # 4092 samples/code -> 1023 = 1/chip
        n = spec.samples_per_code(fs)
        x = synthesize(
            [SatelliteScenario(prn=6, doppler_hz=1500.0,
                               code_phase_chips=123.0, amplitude=0.3)],
            11 * n, fs, noise_std=1.0, seed=15,
        )
        cands = eng.search(np.asarray(x), window_offset=0,
                           allowed_prns={3, 6, 27})
        assert [c.prn for c in cands] == [6]
        expected_lag = round((1023 - 123.0) * fs / 1.023e6) % n
        assert abs(cands[0].code_phase_samples - expected_lag) <= 2
        assert cands[0].carrier_freq_hz == pytest.approx(1500.0, abs=30.0)

    def test_fine_doppler_conv_matches_fft(self):
        """The FFT-free fine-Doppler refinement must agree with the
        zero-padded-FFT version within grid resolution."""
        import jax.numpy as jnp

        fs = 2_046_000.0
        n = GPS_L1CA.samples_per_code(fs)
        true_dop = 1789.0
        sig = synthesize([SatelliteScenario(prn=7, doppler_hz=true_dop,
                                            amplitude=0.5)],
                         11 * n, fs, noise_std=0.5, seed=9)
        codes = jnp.asarray(np.stack([
            GPS_L1CA.sample_code(7, GPS_L1CA.code_rate_hz, fs)
        ]).astype(np.float32))
        cp = jnp.asarray([0], jnp.int32)
        coarse = jnp.asarray([2000.0], jnp.float32)
        f_fft = float(pcps.fine_doppler(
            sig[:10 * n].astype(np.complex64), codes, cp, coarse,
            fs_hz=fs, n_int=10)[0])
        f_conv = float(pcps.fine_doppler_conv(
            np.real(sig[:10 * n]).astype(np.float32),
            np.imag(sig[:10 * n]).astype(np.float32),
            codes, cp, coarse, fs_hz=fs, n_int=10)[0])
        assert abs(f_conv - true_dop) < 15.0
        assert abs(f_conv - f_fft) < 15.0


class TestWeakSignalBitEdgeGate:
    """Weak-signal sensitivity gate (VERDICT round-1 item 6).

    A ~31 dB-Hz satellite (the regime of the reference capture's hard
    PRNs 9/28, config.txt note [2]: "5-9 ms integration" needed) with
    live data-bit modulation:

      * plain 40 ms non-coherent integration MISSES (peak/avg < 7);
      * 20 ms coherent integration DETECTS but reports a carrier
        frequency biased by the data-bit sideband when a bit edge
        splits the coherent window — a poisoned tracking handoff;
      * coherent + bit-edge hypotheses detects at the TRUE carrier and
        code phase with the largest margin.

    Bit edges land at the exact centers of the default group windows
    (the adversarial alignment), and the scene uses physical code
    Doppler. This documents the sensitivity floor: ~31 dB-Hz at
    20 ms coherent / 40 ms total with a 25 Hz grid.
    """

    def test_bit_edge_hypotheses_recover_weak_satellite(self):
        import jax.numpy as jnp

        fs = 2_046_000.0
        n0 = GPS_L1CA.samples_per_code(fs)
        n_int = 40
        # 25 Hz step: residual Doppler stays << 1/(20 ms coherent)
        grid = jnp.asarray(
            np.arange(-1000.0, 1001.0, 25.0).astype(np.float32))
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, fs, 32)

        # C/N0 = A^2 * fs / noise_std^2 = 0.025^2 * 2.046e6 ~= 31.1 dB-Hz.
        # code_phase 10*1023 chips puts bit edges at ms 10 and 30 — dead
        # center of the default coherent groups [0,20) and [20,40)
        sat = SatelliteScenario(
            prn=7, doppler_hz=250.0, code_phase_chips=10 * 1023.0,
            nav_bits=np.array([1.0, -1.0]), amplitude=0.025,
        ).with_code_doppler()
        x = jnp.asarray(
            synthesize([sat], n_int * n0, fs, noise_std=1.0, seed=3))

        noncoh = pcps.pcps_search(
            x, code_ffts, grid, fs_hz=fs, n_int=n_int)
        coh = pcps.pcps_search(
            x, code_ffts, grid, fs_hz=fs, n_int=n_int, coherent=20)
        hyp = pcps.pcps_search(
            x, code_ffts, grid, fs_hz=fs, n_int=n_int, coherent=20,
            bit_edge_hypotheses=4)

        i = 6  # PRN 7
        # 1. non-coherent integration cannot see it at the reference
        #    threshold
        assert float(noncoh.ratio[i]) < 7.0
        # 2. plain coherent detects — at a data-sideband frequency, NOT
        #    the true carrier (biased handoff)
        assert float(coh.ratio[i]) > 7.0
        assert abs(float(coh.carrier_freq_hz[i]) - 250.0) >= 25.0
        # 3. hypotheses: detected at the true carrier and code phase,
        #    with more margin than the edge-split coherent sum
        assert float(hyp.ratio[i]) > 7.0
        assert float(hyp.carrier_freq_hz[i]) == pytest.approx(250.0)
        assert int(hyp.code_phase_samples[i]) == 0
        assert float(hyp.ratio[i]) > float(coh.ratio[i])
        # the peak/avg statistic of a single 20 ms coherent sum has a
        # higher noise floor than 10x-non-coherent (threshold 7 is
        # calibrated for the latter, do_acquisition.rs:237,23): the
        # operational gate is separation — the true satellite must
        # stand clear above every noise-only PRN's statistic
        ratios = np.asarray(hyp.ratio)
        noise_floor = float(ratios[np.arange(32) != i].max())
        assert float(ratios[i]) > 1.5 * noise_floor
