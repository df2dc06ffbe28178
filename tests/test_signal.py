"""Synthetic signal oracle tests (reference generator semantics:
src/tracking/do_tracking.rs:434-462)."""
import numpy as np

from gnss_sdr.models import (
    GALILEO_E1B,
    GPS_L1CA,
    SatelliteScenario,
    synthesize,
    synthesize_real_if_int8,
)
from gnss_sdr.models.codes import gps_l1ca


def test_matches_reference_generator_semantics():
    """Bit-for-bit reimplementation of the reference's synthetic generator
    for one satellite at baseband must agree with synthesize()."""
    fs = 4_096_000.0
    prn, doppler, phi0, cp0 = 2, 3000.0, 0.3, 0.25
    n = int(fs / 1000.0)

    code = gps_l1ca.generate_code(prn)
    step = 1.023e6 / fs
    i = np.arange(n)
    carrier = phi0 + 2.0 * np.pi * doppler / fs * i
    chips = code[np.floor(cp0 + step * i).astype(int) % 1023]
    expected = chips * np.exp(1j * carrier)

    got = synthesize(
        [SatelliteScenario(prn=prn, doppler_hz=doppler,
                           carrier_phase_rad=phi0, code_phase_chips=cp0)],
        n, fs,
    )
    np.testing.assert_allclose(got, expected.astype(np.complex64), atol=1e-4)


def test_chunked_rendering_is_continuous():
    fs = 2_048_000.0
    sats = [SatelliteScenario(prn=5, doppler_hz=-1234.5, code_phase_chips=100.2)]
    full = synthesize(sats, 4096, fs, f_if_hz=10_000.0)
    a = synthesize(sats, 2048, fs, f_if_hz=10_000.0)
    b = synthesize(sats, 2048, fs, f_if_hz=10_000.0, start_sample=2048)
    np.testing.assert_allclose(np.concatenate([a, b]), full, atol=1e-5)


def test_nav_bits_modulate_at_20ms():
    fs = 1_023_000.0  # 1 sample/chip, 1023 samples/ms
    bits = np.array([1, -1], dtype=np.int8)
    sat = SatelliteScenario(prn=1, nav_bits=bits)
    n_ms = 21
    x = synthesize([sat], 1023 * n_ms, fs)
    code = gps_l1ca.generate_code(1).astype(np.float64)
    # ms 0..19 carry bit +1, ms 20 carries bit -1
    np.testing.assert_allclose(x[:1023].real, code, atol=1e-4)
    np.testing.assert_allclose(x[20 * 1023:21 * 1023].real, -code, atol=1e-4)


def test_multi_satellite_superposition():
    fs = 2_048_000.0
    s1 = SatelliteScenario(prn=1, doppler_hz=1000.0)
    s2 = SatelliteScenario(prn=9, doppler_hz=-2500.0, amplitude=0.5)
    x12 = synthesize([s1, s2], 2048, fs)
    x1 = synthesize([s1], 2048, fs)
    x2 = synthesize([s2], 2048, fs)
    np.testing.assert_allclose(x12, x1 + x2, atol=1e-4)


def test_boc_signal_has_subcarrier():
    fs = 1.023e6 * 8
    x = synthesize([SatelliteScenario(prn=1, signal=GALILEO_E1B)], 64, fs)
    chips = GALILEO_E1B.code_table()[0]
    # first chip: 4 samples +c0 then 4 samples -c0
    np.testing.assert_allclose(x[:4].real, chips[0] * np.ones(4), atol=1e-4)
    np.testing.assert_allclose(x[4:8].real, -chips[0] * np.ones(4), atol=1e-4)


def test_real_if_int8_capture_format():
    fs, f_if = 16_367_600.0, 4_130_400.0
    raw = synthesize_real_if_int8(
        [SatelliteScenario(prn=3, doppler_hz=1500.0)], 16368, fs, f_if
    )
    assert raw.dtype == np.int8
    assert raw.shape == (16368,)
    assert np.max(np.abs(raw.astype(np.int32))) <= 127
    # BPSK-spread energy centered at IF: in-band energy must dominate an
    # equally wide out-of-band region
    spec = np.abs(np.fft.rfft(raw.astype(np.float64))) ** 2
    freqs = np.arange(spec.size) * fs / 16368
    in_band = spec[np.abs(freqs - f_if) < 0.5e6].mean()
    out_band = spec[np.abs(freqs - 7.5e6) < 0.5e6].mean()
    assert in_band > 10.0 * out_band


def test_noise_reproducible():
    a = synthesize([], 1000, 1e6, noise_std=1.0, seed=42)
    b = synthesize([], 1000, 1e6, noise_std=1.0, seed=42)
    np.testing.assert_array_equal(a, b)
    assert np.std(a) > 0.5
