"""Unit gates for the non-GPS nav-message codecs.

Each codec ships an encoder oracle; decode(encode(x)) == x is the
correctness contract (same policy as the LNAV encoder in nav/bits.py),
plus error-correction and streaming-sync behavior under polarity flips,
arbitrary epoch phase, and noise.
"""
import numpy as np
import pytest

from gnss_sdr.nav import bds_d1, glonass_nav as gn, inav
from gnss_sdr.nav.ephemeris import Ephemeris


def galileo_ephemeris() -> Ephemeris:
    return Ephemeris(
        prn=11, system="galileo", sqrt_a=5440.588, e=0.01, m0=1.2,
        omega0=-2.1, i0=0.96, omega=0.5, omega_dot=-8.0e-9, idot=3.0e-10,
        delta_n=4.5e-9, c_uc=1e-6, c_us=2e-6, c_rc=200.0, c_rs=-50.0,
        c_ic=5e-8, c_is=-4e-8, t_oe=3600.0, t_oc=3600.0, a_f0=1e-4,
        a_f1=-2e-11, a_f2=0.0, t_gd=3e-9, ura=107, week=1234,
    )


def beidou_ephemeris() -> Ephemeris:
    return Ephemeris(
        prn=8, system="beidou", sqrt_a=5282.6, e=0.002, m0=0.7,
        omega0=1.1, i0=0.956, omega=-2.4, omega_dot=-7e-9, idot=2e-10,
        delta_n=4e-9, c_uc=1e-6, c_us=7e-6, c_rc=180.0, c_rs=60.0,
        c_ic=4e-8, c_is=1e-8, t_oe=241920.0, t_oc=241920.0, a_f0=2e-5,
        a_f1=1e-12, a_f2=0.0, t_gd=4e-9, week=700, ura=2, iodc=11,
        iode=11, health=0,
    )


def glonass_ephemeris() -> gn.GlonassEphemeris:
    return gn.GlonassEphemeris(
        prn=5, pos_m=np.array([11e6, -13e6, 19e6]),
        vel_m_s=np.array([-1200.0, 2500.0, 900.0]),
        acc_m_s2=np.array([1e-6, -2e-6, 3e-6]),
        t_b_s=11700.0, gamma_n=2e-12, tau_n=-5e-7, nt=400, health=0,
    )


_KEPLER_FIELDS = (
    "sqrt_a", "e", "m0", "omega0", "i0", "omega", "omega_dot", "idot",
    "delta_n", "c_uc", "c_us", "c_rc", "c_rs", "c_ic", "c_is", "t_oe",
    "t_oc", "a_f0", "a_f1", "a_f2", "t_gd",
)


def assert_kepler_close(got: Ephemeris, want: Ephemeris, lsb: dict):
    for f in _KEPLER_FIELDS:
        scale = lsb[f]
        assert abs(getattr(got, f) - getattr(want, f)) <= scale, (
            f, getattr(got, f), getattr(want, f))


class TestInavCodec:
    def test_conv_code_roundtrip_and_correction(self):
        rng = np.random.default_rng(0)
        bits = np.concatenate([rng.integers(0, 2, 114).astype(np.uint8),
                               np.zeros(6, np.uint8)])
        sym = inav.conv_encode(bits)
        assert np.array_equal(inav.viterbi_decode(sym, 120), bits)
        # K=7 rate-1/2 corrects well-separated symbol errors
        bad = sym.copy()
        bad[np.arange(10, 230, 20)] ^= 1
        assert np.array_equal(inav.viterbi_decode(bad, 120), bits)

    def test_interleaver_roundtrip(self):
        x = np.arange(240)
        assert np.array_equal(inav.deinterleave(inav.interleave(x)), x)

    def test_crc24q_detects_corruption(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, 196).astype(np.uint8)
        c = inav.crc24q(bits)
        bits[57] ^= 1
        assert inav.crc24q(bits) != c

    def test_page_part_roundtrip(self):
        rng = np.random.default_rng(2)
        info = rng.integers(0, 2, 114).astype(np.uint8)
        part = inav.encode_page_part(info)
        assert part.size == inav.PAGE_SYMBOLS
        assert np.array_equal(inav.decode_page_part(part), info)

    def test_stream_decode_with_offset_and_polarity(self):
        truth = galileo_ephemeris()
        stream = inav.encode_symbol_stream(truth, wn=1234, tow0_s=5000.0,
                                           n_pages=7)
        stream = np.concatenate([np.array([1, -1, 1], np.int8), -stream])
        epochs = np.arange(stream.size) + 1000
        dec = inav.InavDecoder(prn=truth.prn)
        for k in range(0, stream.size, 37):
            dec.feed_array(stream[k:k + 37].astype(float),
                           epochs[k:k + 37])
        assert dec.word_count == 7
        assert dec.ephemeris is not None
        lsb = {f: s for f, s in zip(_KEPLER_FIELDS, (
            2**-19, 2**-33, 2**-30, 2**-30, 2**-30, 2**-30, 2**-42,
            2**-42, 2**-42, 2**-29, 2**-29, 2**-5, 2**-5, 2**-29,
            2**-29, 60, 60, 2**-34, 2**-46, 2**-59, 2**-32))}
        assert_kepler_close(dec.ephemeris, truth, lsb)
        g = dec.assembler.gst
        # word 5 is nominal page 4: TOW = tow0 + 2*4, stamped at the
        # even page part's first sync symbol (page 4 even = part 8)
        assert g.tow_s == 5008.0 and g.wn == 1234
        assert g.even_page_epoch == 1000 + 3 + 8 * inav.PAGE_SYMBOLS


class TestBdsD1Codec:
    def test_bch_roundtrip_and_single_error(self):
        rng = np.random.default_rng(3)
        for _ in range(30):
            data = rng.integers(0, 2, 11).astype(np.uint8)
            cw = bds_d1.bch_encode(data)
            assert np.array_equal(bds_d1.bch_decode(cw), data)
            p = int(rng.integers(0, 15))
            cw2 = cw.copy()
            cw2[p] ^= 1
            assert np.array_equal(bds_d1.bch_decode(cw2), data)

    def test_subframe_roundtrip(self):
        truth = beidou_ephemeris()
        f = bds_d1.ephemeris_fields(truth)
        for fra in (1, 2, 3):
            sf = bds_d1.encode_subframe(fra, 345600 + 6 * fra, f[fra])
            dec = bds_d1.decode_subframe(sf)
            assert dec is not None
            assert dec[0] == fra and dec[1] == 345600 + 6 * fra

    def test_chain_nh_sync_noise_polarity_phase(self):
        truth = beidou_ephemeris()
        rng = np.random.default_rng(4)
        bits = bds_d1.encode_bit_stream(truth, sow0=345600, n_subframes=9)
        nh = bds_d1.NH.astype(np.float64)
        prompts = (np.repeat(bits, 20).astype(np.float64)
                   * np.tile(nh, bits.size))
        prompts = -prompts * 1000.0          # Costas flip
        prompts += rng.standard_normal(prompts.size) * 150.0
        epochs = np.arange(prompts.size) + 7  # NH phase != 0
        chain = bds_d1.BdsD1Chain(prn=truth.prn)
        events = []
        for k in range(0, prompts.size, 487):
            events += chain.feed_array(prompts[k:k + 487],
                                       epochs[k:k + 487])
        assert chain.count >= 8
        assert chain.ephemeris is not None
        lsb = {f: s for f, s in zip(_KEPLER_FIELDS, (
            2**-19, 2**-33, 2**-30, 2**-30, 2**-30, 2**-30, 2**-42,
            2**-42, 2**-42, 2**-30, 2**-30, 2**-5, 2**-5, 2**-30,
            2**-30, 8, 8, 2**-32, 2**-49, 2**-58, 1e-10))}
        assert_kepler_close(chain.ephemeris, truth, lsb)
        ev = events[0]
        # SOW stamps each subframe's first bit (6000 epochs apart)
        assert (ev.epoch - 7) % 6000 == 0
        assert ev.tow_s == 345600 + 6 * ((ev.epoch - 7) // 6000)


class TestGlonassCodec:
    def test_hamming_roundtrip_and_single_error(self):
        rng = np.random.default_rng(5)
        for _ in range(30):
            d = rng.integers(0, 2, 77).astype(np.uint8)
            s = gn.hamming_encode(d)
            assert np.array_equal(gn.hamming_decode(s), d)
            p = int(rng.integers(0, 85))
            s2 = s.copy()
            s2[p] ^= 1
            assert np.array_equal(gn.hamming_decode(s2), d)

    def test_string_line_roundtrip(self):
        truth = glonass_ephemeris()
        f = gn.ephemeris_fields(truth, tk_s=11430.0)
        for m in (1, 2, 3, 4):
            s = gn.encode_string(m, f[m])
            line = gn.encode_line(s)
            bits = gn.decode_line(line.astype(float))
            assert np.array_equal(bits, s)
            dec = gn.decode_string(bits)
            assert dec is not None and dec[0] == m

    @pytest.mark.parametrize("phase", [0, 3, 9])
    def test_chain_arbitrary_phase(self, phase):
        truth = glonass_ephemeris()
        rng = np.random.default_rng(6)
        stream = gn.encode_bit_stream(truth, tk_s=11430.0, n_strings=9)
        prompts = np.repeat(stream, 10).astype(np.float64) * -800.0
        prompts += rng.standard_normal(prompts.size) * 120.0
        epochs = np.arange(prompts.size) + phase
        chain = gn.GlonassNavChain(prn=truth.prn)
        events = []
        for k in range(0, prompts.size, 333):
            events += chain.feed_array(prompts[k:k + 333],
                                       epochs[k:k + 333])
        # the half-symbol phase must be discovered exactly: a 1-epoch
        # error would bias every anchor by 1 ms (300 km of range)
        assert chain._half_phase == phase % 10
        assert chain.ephemeris is not None
        got = chain.ephemeris
        assert np.allclose(got.pos_m, truth.pos_m, atol=2.0)
        assert np.allclose(got.vel_m_s, truth.vel_m_s, atol=1e-3)
        assert abs(got.tau_n - truth.tau_n) < 2e-9
        assert got.t_b_s == truth.t_b_s and got.nt == truth.nt
        ev = events[0]
        assert (ev.epoch - phase) % 2000 == 0
        assert ev.tow_s == 11430.0 + 2.0 * ((ev.epoch - phase) // 2000)


class TestGlonassOrbit:
    def test_propagation_stays_on_orbit(self):
        from gnss_sdr.nav.orbits import glonass_satellite_position

        r = 25_508_000.0
        v = np.sqrt(3.986004418e14 / r)
        geph = gn.GlonassEphemeris(
            prn=3, pos_m=np.array([r, 0.0, 0.0]),
            vel_m_s=np.array([0.0, v * 0.6, v * 0.8]),
            acc_m_s2=np.zeros(3), t_b_s=40000.0, tau_n=1e-6,
        )
        p, vel, clk = glonass_satellite_position(geph, 40900.0)
        assert 24_000e3 < np.linalg.norm(p) < 27_000e3
        assert 3000.0 < np.linalg.norm(vel) < 4500.0
        assert clk == pytest.approx(-1e-6)

    def test_rk4_step_invariance(self):
        from gnss_sdr.nav.orbits import glonass_satellite_position

        geph = glonass_ephemeris()
        p1, _, _ = glonass_satellite_position(geph, 11700.0 + 600.0)
        p2, _, _ = glonass_satellite_position(geph, 11700.0 + 600.0,
                                              max_step_s=10.0)
        assert np.allclose(p1, p2, atol=1e-3)


class TestMixedPvt:
    def test_per_system_clock_columns(self):
        """Mixed GPS+Galileo solve recovers position when the two
        systems' pseudoranges carry different clock offsets."""
        from gnss_sdr.nav.pvt import solve_pvt
        from gnss_sdr.nav.orbits import satellite_position
        from gnss_sdr import constants as C

        rx = np.array([4_027_894.0, 307_045.7, 4_919_474.9])
        ephs, txs, prs = [], [], []
        rng = np.random.default_rng(7)
        gps_bias_m, gal_bias_m = 5000.0, 9000.0
        for k in range(8):
            sys = "gps" if k < 4 else "galileo"
            e = Ephemeris(
                prn=k + 1, system=sys, sqrt_a=np.sqrt(26_560e3),
                e=0.001, m0=rng.uniform(-np.pi, np.pi),
                omega0=rng.uniform(-np.pi, np.pi),
                i0=0.96, omega=0.0, t_oe=3600.0, t_oc=3600.0,
            )
            t_tx = 3600.0
            pos, _, clk = satellite_position(e, t_tx)
            if np.dot(pos - rx, rx / np.linalg.norm(rx)) < 0:
                pos = -pos  # cheap way to keep geometry diverse
                e.m0 = (e.m0 + np.pi) % (2 * np.pi)
                pos, _, clk = satellite_position(e, t_tx)
            r = np.linalg.norm(pos - rx)
            tof = r / C.SPEED_OF_LIGHT_M_S
            theta = C.OMEGA_E_DOT_RAD_S * tof
            rot = np.array([[np.cos(theta), np.sin(theta), 0],
                            [-np.sin(theta), np.cos(theta), 0],
                            [0, 0, 1.0]])
            r_sagnac = np.linalg.norm(rot @ pos - rx)
            bias = gps_bias_m if sys == "gps" else gal_bias_m
            prs.append(r_sagnac + bias - C.SPEED_OF_LIGHT_M_S * clk)
            txs.append(t_tx)
            ephs.append(e)
        sol = solve_pvt(prs, ephs, txs)
        assert sol is not None
        assert np.linalg.norm(sol.position_ecef_m - rx) < 1.0
        assert sol.clock_bias_by_system_m["gps"] == pytest.approx(
            gps_bias_m, abs=0.5)
        assert sol.clock_bias_by_system_m["galileo"] == pytest.approx(
            gal_bias_m, abs=0.5)
