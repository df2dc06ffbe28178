"""Acquisition + tracking across constellations (BASELINE.md config
ladder 3-4). The reference hardcodes GPS L1 C/A everywhere; these tests
prove the engines are signal-generic: Galileo E1 BOC(1,1) (4 ms codes,
sub-chip correlator tables), BeiDou B1I (2046 chips), GLONASS L1OF
(FDMA: one code, satellites separated in frequency)."""
import numpy as np
import pytest

from gnss_sdr.config import TrackConfig
from gnss_sdr.models import (
    BEIDOU_B1I,
    GALILEO_E1B,
    GLONASS_L1OF,
    SatelliteScenario,
    synthesize,
)
from gnss_sdr.ops import pcps
from gnss_sdr.receiver import tracking as trk


def acquire_and_track(spec, fs, prn, doppler, n_int, n_prn,
                      amplitude=0.3, seed=0, track_epochs=40,
                      track_channels=2):
    """Generic cold-start -> track flow for any SignalSpec."""
    n0 = spec.samples_per_code(fs)
    total = (n_int + 2) * n0 + track_epochs * n0
    sig = synthesize(
        [SatelliteScenario(prn=prn, doppler_hz=doppler, amplitude=amplitude,
                           signal=spec)],
        total, fs, noise_std=1.0, seed=seed,
    )

    code_ffts = pcps.code_replica_ffts(spec, fs, n_prn)
    grid = pcps.doppler_grid(10_000.0, 250.0)
    res = pcps.pcps_search(
        sig[: n_int * n0], code_ffts, grid, fs_hz=fs, n_int=n_int
    )
    detected = set(np.where(np.asarray(res.detected))[0] + 1)
    lag = int(res.code_phase_samples[prn - 1])
    coarse = float(res.carrier_freq_hz[prn - 1])

    # fine doppler before handoff
    codes_f = np.stack([
        spec.sample_code(p, spec.code_rate_hz, fs) for p in range(1, n_prn + 1)
    ]).astype(np.float32)
    fine = float(np.asarray(pcps.fine_doppler(
        sig[: n_int * n0], codes_f, res.code_phase_samples,
        res.carrier_freq_hz, fs_hz=fs, n_int=n_int,
    ))[prn - 1])

    cfg = TrackConfig(n_channels=track_channels)
    params = trk.TrackParams.create(cfg, spec, fs)
    codes = trk.make_code_table(spec, n_prn)
    state = trk.init_state(track_channels)
    state = trk.start_channel(state, 0, prn - 1, fine, lag, spec.code_rate_hz)
    codes_ch = codes[np.maximum(np.asarray(state.prn_idx), 0)]
    re = np.real(sig).astype(np.float32)
    im = np.imag(sig).astype(np.float32)
    state, telem = trk.track_block(params, codes_ch, state, re, im, track_epochs)
    return detected, coarse, fine, state, telem


class TestGalileoE1B:
    def test_boc_acquire_and_track(self):
        fs = 8_184_000.0  # 8 samples/chip: resolves the BOC subcarrier
        true_doppler = 1837.0
        detected, coarse, fine, state, telem = acquire_and_track(
            GALILEO_E1B, fs, prn=12, doppler=true_doppler,
            n_int=2, n_prn=16, amplitude=0.25, track_epochs=30,
        )
        assert 12 in detected
        assert abs(coarse - true_doppler) <= 150.0
        assert abs(fine - true_doppler) < 40.0
        locked = np.asarray(telem.locked)[:, 0]
        assert locked.all(), "BOC tracking must hold lock"
        # converged within a few Hz over 30 x 4 ms epochs
        assert abs(float(state.carr_freq[0]) - true_doppler) < 10.0

    def test_boc_code_table_has_subcarrier(self):
        codes = trk.make_code_table(GALILEO_E1B, 2)
        assert codes.shape == (2, 2 * 4092)
        chips = GALILEO_E1B.code_table()[0]
        got = np.asarray(codes[0][:4])
        np.testing.assert_array_equal(
            got, [chips[0], -chips[0], chips[1], -chips[1]]
        )

    def test_epoch_length_is_4ms(self):
        fs = 8_184_000.0
        cfg = TrackConfig(n_channels=1)
        params = trk.TrackParams.create(cfg, GALILEO_E1B, fs)
        assert params.samples_per_code_nominal == 32736
        assert params.oversample == 2
        assert params.dt == pytest.approx(0.004)


class TestBeidouB1I:
    def test_acquire_and_track(self):
        fs = 8_184_000.0  # 4 samples/chip at 2.046 Mcps
        true_doppler = -2641.0
        detected, coarse, fine, state, telem = acquire_and_track(
            BEIDOU_B1I, fs, prn=19, doppler=true_doppler,
            n_int=5, n_prn=37, amplitude=0.25, track_epochs=40,
        )
        assert 19 in detected
        assert abs(fine - true_doppler) < 30.0
        locked = np.asarray(telem.locked)[:, 0]
        assert locked.all()
        assert abs(float(state.carr_freq[0]) - true_doppler) < 8.0


class TestGlonassL1OF:
    def test_fdma_channel_separation(self):
        """GLONASS satellites share one code; the receiver separates
        them by FDMA channel. Searching a grid spanning the channel
        offsets must find each satellite at its channel frequency."""
        fs = 4_088_000.0  # 8 samples/chip at 0.511 Mcps
        spec = GLONASS_L1OF
        n0 = spec.samples_per_code(fs)
        spacing = 562_500.0
        # two satellites on FDMA channels -1 and +2 (relative carriers)
        sats = [
            SatelliteScenario(prn=1, doppler_hz=-spacing + 900.0,
                              amplitude=0.3, signal=spec),
            SatelliteScenario(prn=1, doppler_hz=2 * spacing - 1500.0,
                              amplitude=0.3, signal=spec,
                              code_phase_chips=200.0),
        ]
        sig = synthesize(sats, 5 * n0, fs, noise_std=1.0, seed=3)
        code_ffts = pcps.code_replica_ffts(spec, fs, 1)
        for k, true_resid in ((-1, 900.0), (2, -1500.0)):
            grid = pcps.doppler_grid(10_000.0, 250.0) + np.float32(k * spacing)
            res = pcps.pcps_search(
                sig, code_ffts, grid, fs_hz=fs, n_int=5
            )
            assert bool(np.asarray(res.detected)[0]), f"channel {k} missed"
            got = float(res.carrier_freq_hz[0]) - k * spacing
            assert abs(got - true_resid) <= 150.0

    def test_track_on_channel_offset(self):
        fs = 4_088_000.0
        spec = GLONASS_L1OF
        n0 = spec.samples_per_code(fs)
        carrier = 562_500.0 + 777.0  # channel +1 plus doppler
        sig = synthesize(
            [SatelliteScenario(prn=1, doppler_hz=carrier, amplitude=0.4,
                               signal=spec)],
            50 * n0, fs, noise_std=0.5, seed=4,
        )
        cfg = TrackConfig(n_channels=1)
        params = trk.TrackParams.create(cfg, spec, fs)
        codes = trk.make_code_table(spec, 1)
        state = trk.start_channel(
            trk.init_state(1), 0, 0, carrier - 30.0, 0, spec.code_rate_hz
        )
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        state, telem = trk.track_block(
            params, codes[np.array([0])], state, re, im, 40
        )
        assert np.asarray(telem.locked)[:, 0].all()
        assert abs(float(state.carr_freq[0]) - carrier) < 8.0
