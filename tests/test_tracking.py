"""Tracking loop tests.

Closed-loop synthetic-signal convergence tests following the reference's
strategy (reference: src/tracking/do_tracking.rs:464-655: discriminator
sign, NCO direction, error shrinking, exact sample bookkeeping) plus
block-boundary continuity and lost-channel lifecycle, which the reference
never tests.
"""
import numpy as np
import pytest

from gnss_sdr.config import TrackConfig
from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.receiver import tracking as trk

FS = 4_096_000.0
N0 = GPS_L1CA.samples_per_code(FS)  # 4096
CODE_RATE = GPS_L1CA.code_rate_hz


def make_setup(n_channels=4):
    cfg = TrackConfig(n_channels=n_channels)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes_full = trk.make_code_table(GPS_L1CA, 32)
    return cfg, params, codes_full


def run_epochs(params, codes, state, signal, n):
    re = np.real(signal).astype(np.float32)
    im = np.imag(signal).astype(np.float32)
    state, telem = trk.track_block(params, codes, state, re, im, n)
    return state, telem


class TestPllPullIn:
    """Reference test_pll_frequency_pull_in semantics
    (do_tracking.rs:464-570)."""

    def test_discriminator_sign_and_convergence(self):
        cfg, params, codes = make_setup(1)
        true_doppler = 3000.0
        sig = synthesize(
            [SatelliteScenario(prn=2, doppler_hz=true_doppler)],
            60 * N0, FS,
        )
        state = trk.init_state(1)
        # start 50 Hz slow, as the reference test does
        state = trk.start_channel(state, 0, 1, 2950.0, 0, CODE_RATE)
        codes_ch = codes[state.prn_idx]

        state, telem = run_epochs(params, codes_ch, state, sig, 50)
        telem_np = {k: np.asarray(v) for k, v in telem._asdict().items()}

        assert telem_np["processed"].all()
        assert telem_np["locked"].all(), "must hold lock on clean signal"
        # epoch 0: positive phase error, NCO pushes frequency up
        assert telem_np["pll_err"][0, 0] > 0.0
        assert telem_np["carr_freq"][0, 0] > 2950.0
        # converged to the true Doppler
        assert abs(float(state.carr_freq[0]) - true_doppler) < 5.0
        # phase error shrinks over time
        early_err = np.abs(telem_np["pll_err"][:5, 0]).mean()
        late_err = np.abs(telem_np["pll_err"][-5:, 0]).mean()
        assert late_err < early_err

    def test_negative_offset_pulls_down(self):
        cfg, params, codes = make_setup(1)
        sig = synthesize(
            [SatelliteScenario(prn=5, doppler_hz=-1500.0)], 60 * N0, FS
        )
        state = trk.init_state(1)
        state = trk.start_channel(state, 0, 4, -1450.0, 0, CODE_RATE)
        state, _ = run_epochs(params, codes[state.prn_idx], state, sig, 50)
        assert abs(float(state.carr_freq[0]) - (-1500.0)) < 5.0


class TestDllCodeTracking:
    """Reference test_dll_code_phase_tracking semantics
    (do_tracking.rs:572-655)."""

    def test_early_signal_raises_code_rate(self):
        cfg, params, codes = make_setup(1)
        # signal code is 0.25 chips ahead of the replica
        sig = synthesize(
            [SatelliteScenario(prn=3, code_phase_chips=0.25)], 10 * N0, FS
        )
        state = trk.init_state(1)
        state = trk.start_channel(state, 0, 2, 0.0, 0, CODE_RATE)
        state, telem = run_epochs(params, codes[state.prn_idx], state, sig, 3)
        dll = np.asarray(telem.dll_err)
        assert dll[0, 0] > 0.0, "early signal must give positive DLL error"
        assert float(state.code_rate[0]) > CODE_RATE

    def test_sample_bookkeeping_exact(self):
        """offset advances by exactly round(fs*L/code_rate) each epoch
        (reference asserts next_sample_index arithmetic,
        do_tracking.rs:613,632-636)."""
        cfg, params, codes = make_setup(1)
        sig = synthesize([SatelliteScenario(prn=7)], 8 * N0, FS)
        state = trk.init_state(1)
        state = trk.start_channel(state, 0, 6, 0.0, 0, CODE_RATE)

        offsets = [int(state.offset[0])]
        rates = [float(state.code_rate[0])]
        for _ in range(5):
            state, _ = run_epochs(params, codes[state.prn_idx], state, sig, 1)
            offsets.append(int(state.offset[0]))
            rates.append(float(state.code_rate[0]))
        for k in range(5):
            expected = round(FS * 1023 / rates[k])
            assert offsets[k + 1] - offsets[k] == expected

    def test_aligned_signal_keeps_code_phase(self):
        """Perfectly aligned, zero-Doppler signal: chip_int must return to
        0 after each full code period (exact accumulator check)."""
        cfg, params, codes = make_setup(1)
        sig = synthesize([SatelliteScenario(prn=1)], 12 * N0, FS)
        state = trk.init_state(1)
        state = trk.start_channel(state, 0, 0, 0.0, 0, CODE_RATE)
        state, telem = run_epochs(params, codes[state.prn_idx], state, sig, 10)
        assert np.asarray(telem.locked).all()
        # code rate stays within 1 Hz of nominal, chip phase within 0.1 chip
        assert abs(float(state.code_rate[0]) - CODE_RATE) < 1.0
        chip = float(state.chip_int[0]) + float(state.chip_frac_u32[0]) / 2**32
        chip_err = min(chip, 1023 - chip)
        assert chip_err < 0.1


class TestLifecycle:
    def test_lost_channel_resets(self):
        cfg, params, codes = make_setup(1)
        rng = np.random.default_rng(0)
        # weak noise floor: prompt power stays below the lock threshold
        noise = (
            0.01 * (rng.standard_normal(40 * N0) + 1j * rng.standard_normal(40 * N0))
        ).astype(np.complex64)
        state = trk.init_state(1)
        state = trk.start_channel(state, 0, 9, 1000.0, 0, CODE_RATE)
        state, telem = run_epochs(params, codes[state.prn_idx], state, noise, 25)
        lost = np.asarray(telem.lost_event)
        assert lost.sum() == 1, "exactly one lost event"
        # lost after max_lost_epochs consecutive unlocked epochs
        assert int(np.argmax(lost[:, 0])) == cfg.max_lost_epochs - 1
        assert not bool(state.active[0])
        assert int(state.prn_idx[0]) == -1

    def test_idle_channels_untouched(self):
        cfg, params, codes = make_setup(3)
        sig = synthesize([SatelliteScenario(prn=4)], 5 * N0, FS)
        state = trk.init_state(3)
        state = trk.start_channel(state, 1, 3, 0.0, 0, CODE_RATE)
        codes_ch = codes[np.maximum(np.asarray(state.prn_idx), 0)]
        state, telem = run_epochs(params, codes_ch, state, sig, 3)
        proc = np.asarray(telem.processed)
        assert proc[:, 1].all()
        assert not proc[:, 0].any() and not proc[:, 2].any()
        assert int(state.offset[0]) == 0 and int(state.offset[2]) == 0


class TestBlockStreaming:
    def test_continuity_across_blocks(self):
        """Tracking state carried across block boundaries with rebasing
        must be indistinguishable from one long block (the determinism
        requirement in BASELINE.md)."""
        cfg, params, codes = make_setup(1)
        doppler = 2222.0
        # handoff error 42 Hz: within Costas pull-in range (a 500 Hz-bin
        # handoff without fine-Doppler refinement cycle-slips; that is
        # why acquisition runs fine_doppler before handoff)
        start_freq = 2180.0
        total_ms = 60
        sig = synthesize(
            [SatelliteScenario(prn=11, doppler_hz=doppler,
                               carrier_phase_rad=1.0)],
            total_ms * N0, FS,
        )
        codes_ch = codes[np.array([10])]

        # one shot
        state_a = trk.start_channel(
            trk.init_state(1), 0, 10, start_freq, 0, CODE_RATE
        )
        state_a, telem_a = run_epochs(params, codes_ch, state_a, sig, 50)

        # streamed: 20 ms blocks + 5 ms history, catch-up epochs
        block_ms, hist_ms = 20, 5
        b, h = block_ms * N0, hist_ms * N0
        state_b = trk.start_channel(
            trk.init_state(1), 0, 10, start_freq, h, CODE_RATE
        )
        buf = np.zeros(h + b, dtype=np.complex64)
        freq_traj, powers = [], []
        fed = 0
        for blk in range(3):
            buf[:h] = sig[max(0, fed - h):fed] if fed else 0
            buf[h:] = sig[fed:fed + b]
            fed += b
            re = np.real(buf).astype(np.float32)
            im = np.imag(buf).astype(np.float32)
            state_b, telem = trk.track_block(
                params, codes_ch, state_b, re, im, block_ms + 1
            )
            proc = np.asarray(telem.processed)[:, 0]
            freq_traj.append(np.asarray(telem.carr_freq)[proc, 0])
            powers.append(np.asarray(telem.power)[proc, 0])
            state_b = trk.rebase(state_b, b)

        # both converge to the true doppler
        assert abs(float(state_a.carr_freq[0]) - doppler) < 5.0
        assert abs(float(state_b.carr_freq[0]) - doppler) < 5.0
        # streamed path holds lock continuously
        assert all(p.size > 0 and (p > 15.0).all() for p in powers)
        # determinism: streamed trajectory equals the one-shot trajectory
        # epoch-for-epoch (same samples -> same floats; the BASELINE.md
        # "state carries across block boundaries deterministically" gate)
        streamed = np.concatenate(freq_traj)[:50]
        oneshot = np.asarray(telem_a.carr_freq)[:, 0][: streamed.size]
        np.testing.assert_allclose(streamed, oneshot, rtol=0, atol=1e-3)
