"""Carrier aiding and lock-detector-mode tests (beyond-reference
capabilities; reference has neither)."""
import numpy as np
import pytest

from gnss_sdr.config import TrackConfig
from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.receiver import tracking as trk

FS = 2_048_000.0
N0 = GPS_L1CA.samples_per_code(FS)
CODE_RATE = GPS_L1CA.code_rate_hz


def run(cfg, sats, start_freq, epochs=60, seed=0, noise=0.5):
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_code_table(GPS_L1CA, 32)
    sig = synthesize(sats, (epochs + 4) * N0, FS, noise_std=noise, seed=seed)
    state = trk.start_channel(
        trk.init_state(1), 0, sats[0].prn - 1, start_freq, 0, CODE_RATE
    )
    re = np.real(sig).astype(np.float32)
    im = np.imag(sig).astype(np.float32)
    return trk.track_block(
        params, codes[np.array([sats[0].prn - 1])], state, re, im, epochs
    )


class TestCarrierAiding:
    def test_aiding_tracks_code_doppler(self):
        """Physically consistent scene (code rate scaled by Doppler):
        with aiding, the DLL residual code-rate state stays near nominal
        because the carrier loop supplies the code Doppler."""
        doppler = 4000.0
        sat = SatelliteScenario(
            prn=5, doppler_hz=doppler, amplitude=1.0
        ).with_code_doppler()
        true_code_rate = CODE_RATE + sat.code_rate_offset_hz
        assert abs(sat.code_rate_offset_hz - 2.597) < 0.01  # 4kHz * r/fL1

        aided_cfg = TrackConfig(n_channels=1, carrier_aiding=True)
        st_a, telem_a = run(aided_cfg, [sat], doppler - 30.0)
        unaided_cfg = TrackConfig(n_channels=1, carrier_aiding=False)
        st_u, telem_u = run(unaided_cfg, [sat], doppler - 30.0)

        assert np.asarray(telem_a.locked)[:, 0].all()
        # aided: DLL residual stays within a fraction of the code
        # doppler; realized rate (state + aid) matches truth
        realized_a = float(st_a.code_rate[0]) + float(
            st_a.carr_freq[0]
        ) * CODE_RATE / GPS_L1CA.carrier_freq_hz
        assert realized_a == pytest.approx(true_code_rate, abs=0.5)
        assert abs(float(st_a.code_rate[0]) - CODE_RATE) < 1.0

    def test_unaided_reference_behavior_unchanged(self):
        sat = SatelliteScenario(prn=3, doppler_hz=0.0)
        cfg = TrackConfig(n_channels=1, carrier_aiding=False)
        st, telem = run(cfg, [sat], 0.0, epochs=20)
        assert np.asarray(telem.locked)[:, 0].all()
        assert abs(float(st.code_rate[0]) - CODE_RATE) < 1.0


class TestCostasLockDetector:
    def test_scale_invariant(self):
        """The normalized detector declares lock for a clean signal at
        ANY amplitude and refuses noise at any amplitude — unlike the
        reference's absolute power threshold (do_tracking.rs:16)."""
        cfg = TrackConfig(n_channels=1, lock_mode="costas")
        for amp in (0.05, 1.0, 50.0):
            sat = SatelliteScenario(prn=8, doppler_hz=500.0, amplitude=amp)
            st, telem = run(cfg, [sat], 500.0, epochs=20, noise=0.01 * amp)
            assert np.asarray(telem.locked)[:, 0].all(), f"amp {amp}"

    def test_rejects_pure_noise_regardless_of_scale(self):
        cfg = TrackConfig(n_channels=1, lock_mode="costas", max_lost_epochs=10)
        rng = np.random.default_rng(3)
        for scale in (0.01, 100.0):
            noise = (
                scale * (rng.standard_normal(45 * N0)
                         + 1j * rng.standard_normal(45 * N0))
            ).astype(np.complex64)
            params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
            codes = trk.make_code_table(GPS_L1CA, 32)
            state = trk.start_channel(
                trk.init_state(1), 0, 0, 1000.0, 0, CODE_RATE
            )
            st, telem = trk.track_block(
                params, codes[np.array([0])], state,
                np.real(noise).astype(np.float32),
                np.imag(noise).astype(np.float32), 40,
            )
            assert np.asarray(telem.lost_event).sum() == 1, f"scale {scale}"
            assert not bool(st.active[0])


class TestSliceCorrelator:
    """Gather-free 'slice' correlator (restricted-backend path)."""

    def test_tracks_like_shift_path(self):
        from gnss_sdr.models import synthesize as synth

        fs = 4_096_000.0
        n0 = GPS_L1CA.samples_per_code(fs)
        sig = synth([SatelliteScenario(prn=9, doppler_hz=1700.0)],
                    40 * n0, fs, noise_std=0.5, seed=5)
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        results = {}
        for corr in ("shift", "slice"):
            cfg = TrackConfig(n_channels=1, correlator=corr)
            params = trk.TrackParams.create(cfg, GPS_L1CA, fs)
            if corr == "slice":
                codes = trk.make_sampled_code_table(
                    GPS_L1CA, fs, 32, window=params.window
                )
            else:
                codes = trk.make_code_table(GPS_L1CA, 32)
            st = trk.start_channel(trk.init_state(1), 0, 8, 1680.0, 0,
                                   GPS_L1CA.code_rate_hz)
            codes_ch = codes[np.maximum(np.asarray(st.prn_idx), 0)]
            st, telem = trk.track_block(params, codes_ch, st, re, im, 35)
            results[corr] = (st, telem)
        st_a, t_a = results["shift"]
        st_b, t_b = results["slice"]
        assert np.asarray(t_b.locked)[:, 0].all()
        # both converge to the true doppler
        assert abs(float(st_a.carr_freq[0]) - 1700.0) < 5.0
        assert abs(float(st_b.carr_freq[0]) - 1700.0) < 5.0
        # prompt power comparable (slice replica quantization costs a
        # few percent at 4 samples/chip)
        pa = np.asarray(t_a.power)[-5:, 0].mean()
        pb = np.asarray(t_b.power)[-5:, 0].mean()
        assert pb > 0.85 * pa

    def test_receiver_with_slice_correlator(self):
        from gnss_sdr.config import ReceiverConfig, RfConfig
        from gnss_sdr.models import synthesize as synth
        from gnss_sdr.receiver import ArraySource, Receiver

        fs = 2_048_000.0
        sig = synth([SatelliteScenario(prn=24, doppler_hz=-1500.0,
                                       amplitude=0.3)],
                    int(0.3 * fs), fs, noise_std=1.0, seed=7)
        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
            track=TrackConfig(n_channels=4, correlator="slice"),
            block_ms=20,
        )
        rx = Receiver(cfg, ArraySource(sig, fs))
        out = rx.run()
        assert out["tracked_prns"] == [24]
        assert out["channels"][0]["locked_fraction"] > 0.95
