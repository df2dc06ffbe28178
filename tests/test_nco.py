"""Fixed-point NCO exactness properties (ops/nco.py)."""
import numpy as np

from gnss_sdr.ops import nco


def test_phase_ramp_matches_integer_math():
    step = np.uint32(3_000_000_001 % 2**32)
    acc = np.uint32(12345)
    got = np.asarray(nco.phase_ramp(np.uint32(acc), np.uint32(step), 1000))
    expect = (int(acc) + np.arange(1000, dtype=object) * int(step)) % 2**32
    np.testing.assert_array_equal(got.astype(object), expect)


def test_advance_equals_ramp_end():
    step = np.uint32(987654321)
    acc = np.uint32(42)
    n = np.int32(16368)
    end = np.asarray(nco.advance(np.uint32(acc), step, n))
    expect = (42 + 16368 * 987654321) % 2**32
    assert int(end) == expect


def test_freq_to_step_roundtrip():
    fs = 16_367_600.0
    for f in (0.0, 1000.0, 4_130_400.0, -2500.0, fs * 0.9):
        step = int(np.asarray(nco.freq_to_step(np.float32(f), fs)))
        realized = step / 2**32 * fs
        # realized frequency within fs * 2**-24 of requested (mod fs)
        err = (realized - f) % fs
        err = min(err, fs - err)
        assert err < fs * 2**-24 + 1e-6, f"freq {f}: err {err}"


def test_no_drift_over_many_epochs():
    """Cross-epoch accumulation is exact: advancing 1e6 epochs of 16368
    samples equals one advance of the product."""
    step = np.uint32(1234567891)
    acc = np.uint32(0)
    a = nco.advance(acc, step, np.int32(16368))
    for _ in range(9):
        a = nco.advance(a, step, np.int32(16368))
    b = nco.advance(np.uint32(0), step, np.int32(163680))
    assert int(np.asarray(a)) == int(np.asarray(b))


def test_mix_down_rotation():
    # mixing a pure e^{j theta} tone by its own phase yields DC = 1
    n = 256
    step = nco.freq_to_step(np.float32(125_000.0), 1_000_000.0)
    phase = np.asarray(nco.phase_ramp(np.uint32(0), step, n))
    theta = phase.astype(np.float64) * (2 * np.pi / 2**32)
    re = np.cos(theta).astype(np.float32)
    im = np.sin(theta).astype(np.float32)
    out_re, out_im = nco.mix_down(re, im, phase)
    np.testing.assert_allclose(np.asarray(out_re), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_im), 0.0, atol=1e-5)
