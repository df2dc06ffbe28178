"""Digital front-end tests (reference: src/rf/frontend.rs, dc_remove.rs,
nco_lut.rs; the decimator is new capability the reference left TODO)."""
import numpy as np
import pytest

from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.ops import frontend


class TestDcRemoval:
    def test_matches_serial_iir(self):
        """Associative-scan DC tracker must equal the reference's serial
        recurrence (dc_remove.rs:23-29) sample for sample."""
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(5000) + 3.7).astype(np.float32)  # big DC
        alpha = 0.001
        out, _, bias_end, _ = frontend.dc_offset_scan(x, x * 0, alpha)
        # serial oracle
        bias = 0.0
        ref = np.empty_like(x)
        for i, v in enumerate(x):
            bias = (1 - alpha) * bias + alpha * v
            ref[i] = v - bias
        np.testing.assert_allclose(np.asarray(out), ref, atol=2e-3)
        assert float(bias_end) == pytest.approx(bias, abs=2e-3)

    def test_removes_dc_steady_state(self):
        x = np.full(20000, 5.0, np.float32)
        out, _, _, _ = frontend.dc_offset_scan(x, x * 0, 0.001)
        assert abs(float(np.asarray(out)[-1])) < 0.01 * 5.0

    def test_state_carries_across_blocks(self):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(4000) + 1.5).astype(np.float32)
        full, _, _, _ = frontend.dc_offset_scan(x, x * 0, 0.01)
        a, _, br, bi = frontend.dc_offset_scan(x[:2000], x[:2000] * 0, 0.01)
        b, _, _, _ = frontend.dc_offset_scan(
            x[2000:], x[2000:] * 0, 0.01, float(br), float(bi)
        )
        np.testing.assert_allclose(
            np.concatenate([np.asarray(a), np.asarray(b)]),
            np.asarray(full), atol=1e-4,
        )


class TestDecimation:
    def test_tone_preserved(self):
        fs, m = 8_192_000.0, 4
        t = np.arange(65536) / fs
        f0 = 100_000.0
        re = np.cos(2 * np.pi * f0 * t).astype(np.float32)
        im = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        taps = frontend.design_lowpass_fir(64, 0.8 / m)
        dre, dim = frontend.polyphase_decimate(re, im, taps, m)
        dre, dim = np.asarray(dre), np.asarray(dim)
        assert dre.size == re.size // m
        # the tone survives at the same absolute frequency
        spec = np.abs(np.fft.fft(dre + 1j * dim))
        peak = np.argmax(spec)
        freq = peak * (fs / m) / dre.size
        assert freq == pytest.approx(f0, abs=200.0)
        # amplitude preserved within passband ripple
        assert np.abs(spec[peak]) / dre.size == pytest.approx(1.0, abs=0.05)

    def test_alias_rejected(self):
        fs, m = 8_192_000.0, 4
        nyq_out = fs / m / 2  # 1.024 MHz
        f_alias = 1_900_000.0  # above output Nyquist -> must be attenuated
        t = np.arange(65536) / fs
        re = np.cos(2 * np.pi * f_alias * t).astype(np.float32)
        im = np.sin(2 * np.pi * f_alias * t).astype(np.float32)
        taps = frontend.design_lowpass_fir(64, 0.8 / m)
        dre, dim = frontend.polyphase_decimate(re, im, taps, m)
        power = np.mean(np.asarray(dre) ** 2 + np.asarray(dim) ** 2)
        assert power < 1e-3  # > 30 dB rejection


class TestConditionChain:
    def test_if_to_baseband_with_decimation(self):
        """A GPS signal at 16.368 MHz IF capture, mixed to baseband and
        decimated 4x, must still correlate against the code replica at
        the output rate — the full front-end role."""
        fs_in, m = 16_368_000.0, 4
        f_if = 4_092_000.0
        doppler = 1500.0
        n = 16368 * 4  # 4 ms
        sig = synthesize(
            [SatelliteScenario(prn=4, doppler_hz=doppler)],
            n, fs_in, f_if_hz=f_if,
        )
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        out_re, out_im, acc, br, bi, _ = frontend.condition_block(
            re, im, np.float32(f_if), np.uint32(0),
            np.float32(0), np.float32(0),
            fs_hz=fs_in, decimation=m, enable_dc=True,
        )
        fs_out = fs_in / m
        out = np.asarray(out_re) + 1j * np.asarray(out_im)
        # correlate 1 ms at output rate against the replica with the
        # residual doppler wiped off
        n_out = int(fs_out / 1000)
        rep = GPS_L1CA.sample_code(4, 1.023e6, fs_out).astype(np.float32)
        i = np.arange(n_out)
        lo = np.exp(-2j * np.pi * doppler / fs_out * i)
        # skip the FIR transient
        seg = out[n_out:2 * n_out] * lo
        corr = np.abs(np.fft.ifft(np.fft.fft(seg) * np.conj(np.fft.fft(rep))))
        peak, mean = corr.max(), corr.mean()
        assert peak / mean > 10.0, "correlation peak lost through front end"

    def test_mixer_phase_continuity(self):
        fs = 2_048_000.0
        f_if = 300_000.0
        n = 4096
        i = np.arange(2 * n)
        tone_re = np.cos(2 * np.pi * f_if / fs * i).astype(np.float32)
        tone_im = np.sin(2 * np.pi * f_if / fs * i).astype(np.float32)

        r1, i1, acc, br, bi, _ = frontend.condition_block(
            tone_re[:n], tone_im[:n], np.float32(f_if), np.uint32(0),
            np.float32(0), np.float32(0), fs_hz=fs, enable_dc=False,
        )
        r2, i2, _, _, _, _ = frontend.condition_block(
            tone_re[n:], tone_im[n:], np.float32(f_if), acc,
            br, bi, fs_hz=fs, enable_dc=False,
        )
        out = np.concatenate([np.asarray(r1), np.asarray(r2)])
        # mixed-down tone is DC ~ 1.0 with no phase jump at the boundary
        assert np.abs(out - 1.0).max() < 1e-3


class TestPulseBlanking:
    def test_impulses_removed_signal_survives(self):
        """Acquisition through impulsive interference: blanking restores
        detection (the reference's declared-but-unimplemented feature,
        frontend.rs:64)."""
        from gnss_sdr.ops import pcps

        fs = 2_048_000.0
        n = GPS_L1CA.samples_per_code(fs)
        sig = synthesize(
            [SatelliteScenario(prn=8, doppler_hz=1000.0, amplitude=0.2)],
            10 * n, fs, noise_std=1.0, seed=5,
        )
        # strong impulses: 1% of samples at 100x amplitude
        rng = np.random.default_rng(1)
        idx = rng.choice(sig.size, sig.size // 100, replace=False)
        dirty = np.array(sig)
        dirty[idx] += 100.0 * np.exp(1j * rng.random(idx.size) * 6.28)

        re = np.real(dirty).astype(np.float32)
        im = np.imag(dirty).astype(np.float32)
        bre, bim, frac = frontend.pulse_blank(re, im, 5.0)
        assert 0.005 < float(frac) < 0.05

        code_ffts = pcps.code_replica_ffts(GPS_L1CA, fs, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        clean = np.asarray(bre) + 1j * np.asarray(bim)
        r_dirty = pcps.pcps_search(dirty.astype(np.complex64), code_ffts,
                                   grid, fs_hz=fs, n_int=10)
        r_blank = pcps.pcps_search(clean.astype(np.complex64), code_ffts,
                                   grid, fs_hz=fs, n_int=10)
        # blanking must raise the detection statistic substantially
        assert float(r_blank.ratio[7]) > 1.5 * float(r_dirty.ratio[7])
        assert bool(r_blank.detected[7])

    def test_receiver_with_blanking_and_agc(self):
        from gnss_sdr.config import ReceiverConfig, RfConfig, TrackConfig
        from gnss_sdr.receiver import ArraySource, Receiver

        fs = 2_048_000.0
        sig = 50.0 * synthesize(
            [SatelliteScenario(prn=12, doppler_hz=-800.0, amplitude=0.25)],
            int(0.3 * fs), fs, noise_std=1.0, seed=6,
        )  # hot input scale: AGC must normalize it
        rng = np.random.default_rng(2)
        idx = rng.choice(sig.size, sig.size // 200, replace=False)
        sig[idx] += 5000.0

        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs,
                        pulse_blank_sigma=5.0, enable_digital_agc=True),
            track=TrackConfig(n_channels=4),
            block_ms=20,
        )
        rx = Receiver(cfg, ArraySource(sig, fs))
        out = rx.run()
        assert out["tracked_prns"] == [12]
        # AGC pulling the gain down toward ~1/(50*rms) for the 50x-hot
        # input (EMA alpha=0.1: ~0.9^15 of the way after 15 blocks)
        assert 0.01 < float(rx._fe_agc_gain) < 0.5
