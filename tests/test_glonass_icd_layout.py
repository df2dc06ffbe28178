"""GLONASS L1OF decoder vs HAND-BUILT ICD-layout strings.

Oracles transcribed from the GLONASS ICD (edition 5.1) independently of
nav/glonass_nav.py:

  * the KX data-verification index sets (ICD 4.7): the published
    C1..C7 bit-number lists, hard-coded below;
  * the string layouts (ICD table 4.5): absolute bit numbers 85..9,
    sign-magnitude convention.

A wrong check-equation, check-bit placement, or field position in the
module cannot pass these tests.

Reference claim being implemented: /root/reference/README.md:2
("decoding GNSS signals, including ... GLONASS") — the reference
contains no GLONASS code.
"""
from __future__ import annotations

import numpy as np
import pytest

from gnss_sdr.nav import glonass_nav as g

# ICD 4.7 published check index sets (bit numbers within the string,
# 1-based; bit 85 transmitted first). c_k is stored in bit k; the
# overall parity c_sigma in bit 8 covers all 85 bits (even parity).
C_SETS = {
    1: [9, 10, 12, 13, 15, 17, 19, 20, 22, 24, 26, 28, 30, 32, 34, 35,
        37, 39, 41, 43, 45, 47, 49, 51, 53, 55, 57, 59, 61, 63, 65, 66,
        68, 70, 72, 74, 76, 78, 80, 82, 84],
    2: [9, 11, 12, 14, 15, 18, 19, 21, 22, 25, 26, 29, 30, 33, 34, 36,
        37, 40, 41, 44, 45, 48, 49, 52, 53, 56, 57, 60, 61, 64, 65, 67,
        68, 71, 72, 75, 76, 79, 80, 83, 84],
    3: [10, 11, 12, 16, 17, 18, 19, 23, 24, 25, 26, 31, 32, 33, 34, 38,
        39, 40, 41, 46, 47, 48, 49, 54, 55, 56, 57, 62, 63, 64, 65, 69,
        70, 71, 72, 77, 78, 79, 80, 85],
    4: list(range(13, 20)) + list(range(27, 35)) + list(range(42, 50))
       + list(range(58, 66)) + list(range(73, 81)),
    5: list(range(20, 35)) + list(range(50, 66)) + list(range(81, 86)),
    6: list(range(35, 66)),
    7: list(range(66, 86)),
}

# ICD table 4.5 absolute positions: (msb_bit, nbits), bits numbered
# 85 (first transmitted) .. 9; check bits at 8..1.
STR1_POS = {"m": (84, 4), "p1": (78, 2), "tk_h": (76, 5),
            "tk_m": (71, 6), "tk_30": (65, 1), "vx": (64, 24),
            "ax": (40, 5), "x": (35, 27)}
STR2_POS = {"m": (84, 4), "bn": (80, 3), "p2": (77, 1), "tb": (76, 7),
            "vy": (64, 24), "ay": (40, 5), "y": (35, 27)}
STR3_POS = {"m": (84, 4), "p3": (80, 1), "gamma_n": (79, 11),
            "p": (67, 2), "ln": (65, 1), "vz": (64, 24),
            "az": (40, 5), "z": (35, 27)}
STR4_POS = {"m": (84, 4), "tau_n": (80, 22), "dtau_n": (58, 5),
            "en": (53, 5), "p4": (34, 1), "ft": (33, 4),
            "nt": (26, 11), "n": (15, 5), "m_type": (10, 2)}


def hand_build(pos_table: dict, raws: dict) -> np.ndarray:
    """85-bit transmit-order string from absolute ICD bit positions,
    check bits computed from the transcribed C1..C7 sets."""
    bit = np.zeros(86, np.uint8)        # index = ICD bit number, 1..85
    for name, raw in raws.items():
        msb, n = pos_table[name]
        for i in range(n):
            bit[msb - i] = (raw >> (n - 1 - i)) & 1
    for k, idxs in C_SETS.items():
        bit[k] = int(np.bitwise_xor.reduce(bit[idxs]))
    bit[8] = int(np.bitwise_xor.reduce(bit[1:8])) ^ int(
        np.bitwise_xor.reduce(bit[9:86]))
    # transmit order: bit 85 first
    return bit[1:86][::-1].copy()


def sm(value: float, scale: float, n: int) -> int:
    mag = int(round(abs(value) / scale))
    return mag | ((1 << (n - 1)) if value < 0 else 0)


class TestIcdStringLayout:
    def test_string1(self):
        raws = {"m": 1, "p1": 2, "tk_h": 11, "tk_m": 37, "tk_30": 1,
                "vx": sm(-2.3456, 2.0**-20, 24),
                "ax": sm(1.86e-9 / 1e-3 * 1e-3, 2.0**-30, 5),
                "x": sm(11234.5673828125, 2.0**-11, 27)}
        s = hand_build(STR1_POS, raws)
        out = g.decode_string(s)
        assert out is not None
        m, f = out
        assert m == 1
        assert f["p1"] == 2
        assert f["tk_h"] == 11 and f["tk_m"] == 37 and f["tk_30"] == 1
        assert f["vx"] == pytest.approx(-2.3456, abs=2.0**-20)
        assert f["x"] == pytest.approx(11234.5673828125, abs=2.0**-12)

    def test_string2(self):
        raws = {"m": 2, "bn": 4, "p2": 1, "tb": 33,
                "vy": sm(0.5, 2.0**-20, 24), "ay": sm(0.0, 2.0**-30, 5),
                "y": sm(-19001.25, 2.0**-11, 27)}
        s = hand_build(STR2_POS, raws)
        out = g.decode_string(s)
        assert out is not None
        m, f = out
        assert m == 2 and f["bn"] == 4 and f["p2"] == 1
        assert f["tb"] == 33 * 15 * 60.0
        assert f["y"] == pytest.approx(-19001.25, abs=2.0**-12)

    def test_string3(self):
        raws = {"m": 3, "p3": 1,
                "gamma_n": sm(-9.094947017729282e-13, 2.0**-40, 11),
                "p": 3, "ln": 0, "vz": sm(-3.25, 2.0**-20, 24),
                "az": sm(-2.7939677238464355e-09, 2.0**-30, 5),
                "z": sm(9999.5, 2.0**-11, 27)}
        s = hand_build(STR3_POS, raws)
        out = g.decode_string(s)
        assert out is not None
        m, f = out
        assert m == 3 and f["p3"] == 1 and f["p"] == 3 and f["ln"] == 0
        assert f["gamma_n"] == pytest.approx(-9.094947017729282e-13,
                                             rel=1e-12)
        assert f["vz"] == pytest.approx(-3.25)
        assert f["az"] == pytest.approx(-2.7939677238464355e-09)

    def test_string4(self):
        raws = {"m": 4, "tau_n": sm(6.37e-5, 2.0**-30, 22),
                "dtau_n": sm(-2.79e-9, 2.0**-30, 5), "en": 14,
                "p4": 1, "ft": 9, "nt": 1461, "n": 23, "m_type": 1}
        s = hand_build(STR4_POS, raws)
        out = g.decode_string(s)
        assert out is not None
        m, f = out
        assert m == 4
        assert f["en"] == 14 and f["p4"] == 1 and f["ft"] == 9
        assert f["nt"] == 1461 and f["n"] == 23 and f["m_type"] == 1
        assert f["tau_n"] == pytest.approx(6.37e-5, abs=2.0**-30)

    def test_encoder_reproduces_icd_string(self):
        """encode_string's on-air bits equal the hand-built vector —
        layout AND check bits (the full KX equations) agree."""
        fields = {"p1": 1, "tk_h": 7, "tk_m": 15, "tk_30": 0,
                  "vx": -2.25, "ax": 0.0, "x": 12345.5}
        enc = g.encode_string(1, fields)
        raws = {"m": 1, "p1": 1, "tk_h": 7, "tk_m": 15, "tk_30": 0,
                "vx": sm(-2.25, 2.0**-20, 24), "ax": 0,
                "x": sm(12345.5, 2.0**-11, 27)}
        hand = hand_build(STR1_POS, raws)
        assert np.array_equal(enc, hand)

    def test_single_error_correction_any_position(self):
        raws = {"m": 2, "bn": 0, "p2": 0, "tb": 12,
                "vy": sm(1.0, 2.0**-20, 24), "ay": 0,
                "y": sm(100.0, 2.0**-11, 27)}
        clean = hand_build(STR2_POS, raws)
        ref = g.decode_string(clean)
        assert ref is not None
        for pos in range(85):
            bad = clean.copy()
            bad[pos] ^= 1
            out = g.decode_string(bad)
            assert out is not None, f"flip at transmit index {pos}"
            assert out[0] == ref[0]
            assert out[1] == ref[1], f"flip at transmit index {pos}"

    def test_double_error_rejected(self):
        raws = {"m": 1, "p1": 0, "tk_h": 1, "tk_m": 2, "tk_30": 0,
                "vx": 0, "ax": 0, "x": sm(1.0, 2.0**-11, 27)}
        clean = hand_build(STR1_POS, raws)
        bad = clean.copy()
        bad[10] ^= 1
        bad[40] ^= 1
        assert g.decode_string(bad) is None
