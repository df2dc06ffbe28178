"""BeiDou D1 decoder vs HAND-BUILT ICD-layout subframes.

The oracle here is the BDS-SIS-ICD-2.1 absolute bit-position tables
(transcribed below as {start_bit, n_bits} pairs, 1-based, MSB-first,
split across word parity boundaries exactly as published) — NOT the
repo's own encoder. A wrong field order/width in nav/bds_d1.py cannot
pass these tests.

Reference claim being implemented: /root/reference/README.md:2
("decoding GNSS signals, including ... Beidou") — the reference
contains no BeiDou code.
"""
from __future__ import annotations

import numpy as np
import pytest

from gnss_sdr.nav import bds_d1 as d1

# ICD table 5-4..5-8 absolute positions: name -> list of (start, nbits)
# MSB part first. Positions are 1-based bit numbers within the 300-bit
# subframe; each 30-bit word carries 22 information bits then 8 parity.
SF1_POS = {
    "fra_id": [(16, 3)],
    "sow": [(19, 8), (31, 12)],
    "sat_h1": [(43, 1)],
    "aodc": [(44, 5)],
    "urai": [(49, 4)],
    "wn": [(61, 13)],
    "t_oc": [(74, 9), (91, 8)],
    "t_gd": [(99, 10)],
    "t_gd2": [(109, 4), (121, 6)],
    "alpha0": [(127, 8)],
    "alpha1": [(135, 8)],
    "alpha2": [(151, 8)],
    "alpha3": [(159, 8)],
    "beta0": [(167, 6), (181, 2)],
    "beta1": [(183, 8)],
    "beta2": [(191, 8)],
    "beta3": [(199, 4), (211, 4)],
    "a_f2": [(215, 11)],
    "a_f0": [(226, 7), (241, 17)],
    "a_f1": [(258, 5), (271, 17)],
    "aode": [(288, 5)],
}
SF2_POS = {
    "fra_id": [(16, 3)],
    "sow": [(19, 8), (31, 12)],
    "delta_n": [(43, 10), (61, 6)],
    "c_uc": [(67, 16), (91, 2)],
    "m0": [(93, 20), (121, 12)],
    "e": [(133, 10), (151, 22)],
    "c_us": [(181, 18)],
    "c_rc": [(199, 4), (211, 14)],
    "c_rs": [(225, 8), (241, 10)],
    "sqrt_a": [(251, 12), (271, 20)],
    "t_oe_msb": [(291, 2)],
}
SF3_POS = {
    "fra_id": [(16, 3)],
    "sow": [(19, 8), (31, 12)],
    "t_oe_lsb": [(43, 10), (61, 5)],
    "i0": [(66, 17), (91, 15)],
    "c_ic": [(106, 7), (121, 11)],
    "omega_dot": [(132, 11), (151, 13)],
    "c_is": [(164, 9), (181, 9)],
    "idot": [(190, 13), (211, 1)],
    "omega0": [(212, 21), (241, 11)],
    "omega": [(252, 11), (271, 21)],
}

# field scales (must match the decoder's; widths come from the tables)
SCALE = {f[0]: (f[2], f[3]) for sf in (d1._SF1_FIELDS, d1._SF2_FIELDS,
                                       d1._SF3_FIELDS) for f in sf}


def _width(parts):
    return sum(n for _, n in parts)


def place(content: np.ndarray, parts, raw: int) -> None:
    """Write ``raw`` (unsigned, MSB first) at absolute ICD positions."""
    nbits = _width(parts)
    bits = [(raw >> (nbits - 1 - i)) & 1 for i in range(nbits)]
    i = 0
    for start, n in parts:
        for k in range(n):
            content[start - 1 + k] = bits[i]
            i += 1


def build_subframe(pos_table, raw_values: dict) -> np.ndarray:
    """300 on-air bits from absolute-position content + per-word BCH.

    Words 2-10 information bits live at 30w+1..30w+22 (1-based) with
    8 interleaved parity bits per word appended; word 1 is unprotected
    preamble + 4-bit reserve, then BCH(15,11) over bits 16-26.
    """
    content = np.zeros(300, np.uint8)
    content[0:11] = d1.PREAMBLE01
    for name, raw in raw_values.items():
        place(content, pos_table[name], raw)
    out = np.zeros(300, np.uint8)
    out[0:15] = content[0:15]
    out[15:30] = d1.bch_encode(content[15:26])
    for w in range(1, 10):
        info = content[30 * w:30 * w + 22]
        out[30 * w:30 * (w + 1)] = d1.word_encode(info)
    return out


def _raw(value: float, name: str, parts) -> int:
    scale, signed = SCALE[name]
    nbits = _width(parts)
    v = int(round(value / scale)) if scale != 1 else int(value)
    return v & ((1 << nbits) - 1)


class TestIcdLayoutDecodes:
    def test_subframe1_fields(self):
        vals = {
            "sat_h1": 0, "aodc": 11, "urai": 3, "wn": 810,
            "t_oc": 345600.0, "t_gd": 4.3e-9, "t_gd2": -2.1e-9,
            "alpha0": 1.12e-8, "alpha1": -2.98e-8, "alpha2": 5.96e-8,
            "alpha3": -5.96e-8, "beta0": 96256.0, "beta1": -81920.0,
            "beta2": 131072.0, "beta3": -196608.0,
            "a_f2": 1.3e-18, "a_f0": -6.1e-5, "a_f1": 3.7e-12,
            "aode": 17,
        }
        raws = {"fra_id": 1, "sow": 345601}
        for k, v in vals.items():
            raws[k] = _raw(v, k, SF1_POS[k])
        bits = build_subframe(SF1_POS, raws)
        out = d1.decode_subframe(bits)
        assert out is not None
        fra_id, sow, fields = out
        assert fra_id == 1 and sow == 345601
        for k, v in vals.items():
            scale, _ = SCALE[k]
            assert fields[k] == pytest.approx(v, abs=scale * 0.501), k

    def test_subframe2_fields(self):
        vals = {
            "delta_n": 1.2e-9, "c_uc": -3.1e-6, "m0": 1.05,
            "e": 0.0123, "c_us": 7.3e-6, "c_rc": 221.5,
            "c_rs": -98.25, "sqrt_a": 5282.61,
        }
        raws = {"fra_id": 2, "sow": 7, "t_oe_msb": 2}
        for k, v in vals.items():
            raws[k] = _raw(v, k, SF2_POS[k])
        bits = build_subframe(SF2_POS, raws)
        out = d1.decode_subframe(bits)
        assert out is not None
        fra_id, sow, fields = out
        assert fra_id == 2 and sow == 7
        assert fields["t_oe_msb"] == 2
        for k, v in vals.items():
            scale, _ = SCALE[k]
            assert fields[k] == pytest.approx(v, abs=scale * 0.501), k

    def test_subframe3_fields(self):
        vals = {
            "i0": 0.964, "c_ic": -5.2e-8, "omega_dot": -2.1e-9,
            "c_is": 9.8e-8, "idot": 1.4e-10, "omega0": -2.8,
            "omega": 0.44,
        }
        raws = {"fra_id": 3, "sow": 604799, "t_oe_lsb": 31337}
        for k, v in vals.items():
            raws[k] = _raw(v, k, SF3_POS[k])
        bits = build_subframe(SF3_POS, raws)
        out = d1.decode_subframe(bits)
        assert out is not None
        fra_id, sow, fields = out
        assert fra_id == 3 and sow == 604799
        assert fields["t_oe_lsb"] == 31337
        for k, v in vals.items():
            scale, _ = SCALE[k]
            assert fields[k] == pytest.approx(v, abs=scale * 0.501), k

    def test_encoder_reproduces_icd_positions(self):
        """The repo encoder's on-air bits equal the hand-built vector —
        i.e. the sequential packing IS the ICD absolute layout."""
        vals = {"sat_h1": 1, "aodc": 5, "urai": 2, "wn": 700,
                "t_oc": 7200.0, "t_gd": 1e-9, "t_gd2": 2e-9,
                "alpha0": 2.3e-8, "alpha1": 0.0, "alpha2": -1.2e-7,
                "alpha3": 5.96e-8, "beta0": 90112.0, "beta1": 49152.0,
                "beta2": -65536.0, "beta3": 131072.0,
                "a_f2": 0.0, "a_f0": 1e-4, "a_f1": -2e-12, "aode": 9}
        raws = {"fra_id": 1, "sow": 12345}
        for k, v in vals.items():
            raws[k] = _raw(v, k, SF1_POS[k])
        hand = build_subframe(SF1_POS, raws)
        enc = d1.encode_subframe(1, 12345, vals)
        assert np.array_equal(hand, enc)

    def test_wrong_field_order_would_fail(self):
        """Sanity: moving one field off its ICD position breaks decode
        (guards against a future re-ordering regression passing)."""
        raws = {"fra_id": 1, "sow": 99,
                "wn": _raw(810, "wn", SF1_POS["wn"])}
        bits = build_subframe(SF1_POS, raws)
        out = d1.decode_subframe(bits)
        assert out is not None and int(out[2]["wn"]) == 810
        # place wn 22 bits later (one word over): decoder must NOT
        # report 810 in wn
        raws_bad = {"fra_id": 1, "sow": 99}
        content_pos = {"wn": [(91, 13)]}
        bits_bad = build_subframe(
            {**SF1_POS, **content_pos}, {**raws_bad, "wn": 810})
        out_bad = d1.decode_subframe(bits_bad)
        assert out_bad is not None and int(out_bad[2]["wn"]) != 810
