"""Navigation layer tests: bits/parity/frames, ephemeris roundtrip,
RINEX parsing on the reference's bundled file, orbits, PVT geometry.

The reference's legacy decoder (src/decoding.rs) defines the capability
surface but does not compile upstream; these tests gate the proper
IS-GPS-200 implementations via encoder/decoder roundtrips and physical
sanity instead of golden vectors.
"""
import datetime
import os

import numpy as np
import pytest

from gnss_sdr import constants as C
from gnss_sdr.nav import (
    BitSynchronizer,
    Ephemeris,
    EphemerisAssembler,
    FrameDecoder,
    apply_subframe,
    check_word_parity,
    encode_frames,
    encode_subframe,
    encode_words,
    parse_nav_file,
    pseudoranges_from_tracking,
    satellite_position,
    select_ephemerides,
    solve_pvt,
)
from gnss_sdr.nav.bits import compute_parity

RINEX_PATH = "/root/reference/src/test_data/BRDC00WRD_R_20233330000_01D_GN.rnx"


def sample_ephemeris() -> Ephemeris:
    """Realistic GPS ephemeris (magnitudes from a typical broadcast)."""
    return Ephemeris(
        prn=7, week=290, ura=0, health=0, iodc=66, iode=66,
        t_gd=5.122e-09, t_oc=316800.0,
        a_f2=0.0, a_f1=3.41e-13, a_f0=1.6342e-04,
        c_rs=-45.21875, delta_n=4.008e-09, m0=1.2224,
        c_uc=-2.494e-06, e=1.2976e-02, c_us=5.345e-07,
        sqrt_a=5154.0248, t_oe=316784.0,
        c_ic=-2.197e-07, omega0=-0.98540, c_is=3.539e-08,
        i0=0.99038, c_rc=387.28125, omega=1.00056,
        omega_dot=-8.2885e-09, idot=-1.9929e-10,
    )


class TestParity:
    def test_parity_selfconsistent(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            data = rng.integers(0, 2, 24).astype(np.uint8)
            d29, d30 = int(rng.integers(0, 2)), int(rng.integers(0, 2))
            par = compute_parity(data, d29, d30)
            word = np.concatenate([data, par])
            assert check_word_parity(word, d29, d30)
            # flipping any bit breaks parity
            k = int(rng.integers(0, 30))
            bad = word.copy()
            bad[k] ^= 1
            assert not check_word_parity(bad, d29, d30)

    def test_encode_subframe_chains_parity(self):
        rng = np.random.default_rng(1)
        words = rng.integers(0, 2, (8, 24)).astype(np.uint8)
        sf = encode_subframe(3, 12345, words)
        assert sf.shape == (300,)
        d29 = d30 = 0
        for w in range(10):
            word = sf[w * 30:(w + 1) * 30]
            assert check_word_parity(word, d29, d30), f"word {w} parity"
            d29, d30 = int(word[28]), int(word[29])
        # words 2 and 10 end with 00 parity (t-bit constraint)
        assert sf[58] == 0 and sf[59] == 0
        assert sf[298] == 0 and sf[299] == 0


class TestBitSync:
    def test_finds_boundary_and_emits_bits(self):
        rng = np.random.default_rng(2)
        bits = rng.choice([-1, 1], 80).astype(np.int8)
        amp = 100.0
        sync = BitSynchronizer(threshold=30)
        out_bits = []
        # bit boundary at epoch phase 7
        for epoch in range(7, 7 + 80 * 20):
            bit = bits[(epoch - 7) // 20]
            ip = amp * bit + rng.normal(0, 5)
            b = sync.feed(ip, epoch)
            if b is not None:
                out_bits.append(b)
        assert sync.synced
        assert sync.boundary_phase == 7
        got = np.array(out_bits)
        assert got.size >= 10  # sync engaged partway through the stream
        # emitted bits are a contiguous slice of the truth sequence
        found = any(
            np.array_equal(got, bits[k:k + got.size])
            for k in range(bits.size - got.size + 1)
        )
        assert found


class TestFrameDecoder:
    def test_roundtrip_subframes(self):
        rng = np.random.default_rng(3)
        frames = [
            (1, 1000 + i, rng.integers(0, 2, (8, 24)).astype(np.uint8))
            for i in range(4)
        ]
        stream = encode_frames(frames)
        # prepend noise bits and flip polarity
        lead = rng.choice([-1, 1], 37).astype(np.int8)
        full = np.concatenate([lead, stream]) * -1

        dec = FrameDecoder()
        got = []
        for b in full:
            sf = dec.feed(int(b))
            if sf is not None:
                got.append(sf)
        assert dec.frame_locked
        assert dec.polarity == -1
        assert len(got) >= 3
        for k, sf in enumerate(got):
            assert sf.subframe_id == 1
            assert sf.tow_counts in [1000 + i for i in range(4)]
            src = frames[sf.tow_counts - 1000][2]
            # word 10 bits 23-24 are t-bits the encoder solves to force
            # trailing 00 parity (IS-GPS-200 20.3.3.1) — excluded
            np.testing.assert_array_equal(sf.data[2:9], src[:7])
            np.testing.assert_array_equal(sf.data[9][:22], src[7][:22])

    def test_corrupted_word_rejected(self):
        rng = np.random.default_rng(4)
        frames = [
            (2, 500 + i, rng.integers(0, 2, (8, 24)).astype(np.uint8))
            for i in range(3)
        ]
        stream = encode_frames(frames).copy()
        stream[400] *= -1  # corrupt a bit inside subframe 2
        dec = FrameDecoder()
        got = [sf for b in stream if (sf := dec.feed(int(b))) is not None]
        tows = {sf.tow_counts for sf in got}
        assert 501 not in tows  # corrupted subframe must not decode


class TestEphemerisRoundtrip:
    def test_encode_decode_all_subframes(self):
        truth = sample_ephemeris()
        frames = [
            (sid, 700 + sid, encode_words(truth, sid)) for sid in (1, 2, 3)
        ]
        # leading dummy subframe absorbs frame-lock (the first received
        # subframe cannot be parity-verified without the preceding
        # word's D29*/D30*)
        stream = encode_frames(
            [(4, 700, np.zeros((8, 24), np.uint8))]
            + frames
            + [(4, 704, np.zeros((8, 24), np.uint8))]
        )
        dec = FrameDecoder()
        asm = EphemerisAssembler()
        eph = None
        for b in stream:
            sf = dec.feed(int(b))
            if sf is not None:
                got = asm.feed(truth.prn, sf)
                if got is not None:
                    eph = got
        assert eph is not None, "ephemeris not assembled"
        # quantization-limited equality
        assert eph.week == truth.week
        assert eph.iodc == truth.iodc and eph.iode == truth.iode
        assert eph.t_oc == truth.t_oc and eph.t_oe == truth.t_oe
        assert eph.sqrt_a == pytest.approx(truth.sqrt_a, abs=2**-19)
        assert eph.e == pytest.approx(truth.e, abs=2**-33)
        assert eph.m0 == pytest.approx(truth.m0, abs=2**-30 * np.pi)
        assert eph.omega0 == pytest.approx(truth.omega0, abs=2**-30 * np.pi)
        assert eph.i0 == pytest.approx(truth.i0, abs=2**-30 * np.pi)
        assert eph.omega == pytest.approx(truth.omega, abs=2**-30 * np.pi)
        assert eph.delta_n == pytest.approx(truth.delta_n, abs=2**-42 * np.pi)
        assert eph.a_f0 == pytest.approx(truth.a_f0, abs=2**-31)
        assert eph.t_gd == pytest.approx(truth.t_gd, abs=2**-31)
        assert eph.c_rc == pytest.approx(truth.c_rc, abs=2**-5)


@pytest.mark.skipif(
    not os.path.exists(RINEX_PATH), reason="reference RINEX data absent"
)
class TestRinex:
    def test_parse_reference_file(self):
        header, records = parse_nav_file(RINEX_PATH)
        assert header.version.startswith("3")
        assert len(records) > 50
        prns = {r.prn for r in records}
        assert len(prns) > 20
        # first record in the file: G01 2023-11-29 15:59:44
        r0 = records[0]
        assert r0.prn == 1
        assert r0.eph.a_f0 == pytest.approx(1.634210348129e-04)
        assert r0.eph.sqrt_a == pytest.approx(5154.024845123)
        assert r0.eph.week == 2290
        assert r0.eph.iode == 66

    def test_select_freshest(self):
        _, records = parse_nav_file(RINEX_PATH)
        at = datetime.datetime(2023, 11, 29, 18, 0,
                               tzinfo=datetime.timezone.utc)
        ephs = select_ephemerides(records, at)
        assert len(ephs) >= 20
        for eph in ephs.values():
            assert eph.sqrt_a > 5000.0

    def test_orbit_radius_from_real_ephemeris(self):
        _, records = parse_nav_file(RINEX_PATH)
        at = datetime.datetime(2023, 11, 29, 16, 30,
                               tzinfo=datetime.timezone.utc)
        ephs = select_ephemerides(records, at)
        for prn, eph in list(ephs.items())[:8]:
            pos, vel, clk = satellite_position(eph, eph.t_oe + 600.0)
            r = np.linalg.norm(pos)
            # GPS orbits: ~26560 km radius; ECEF speed = inertial
            # (~3.87 km/s) +/- the Earth-rotation component (<=1.9 km/s)
            assert 2.5e7 < r < 2.8e7, f"PRN {prn} radius {r}"
            assert 1500.0 < np.linalg.norm(vel) < 5800.0
            assert abs(clk) < 1e-3

    def test_velocity_consistent_with_finite_difference(self):
        _, records = parse_nav_file(RINEX_PATH)
        eph = records[0].eph
        t = eph.t_oe + 300.0
        p1, v, _ = satellite_position(eph, t)
        p2, _, _ = satellite_position(eph, t + 1.0)
        fd = p2 - p1
        np.testing.assert_allclose(v, fd, rtol=1e-3, atol=0.5)


class TestPvt:
    def _make_scene(self):
        """Synthetic geometry: 6 satellites from the real RINEX file,
        receiver at a known position, exact pseudoranges."""
        _, records = parse_nav_file(RINEX_PATH)
        at = datetime.datetime(2023, 11, 29, 16, 30,
                               tzinfo=datetime.timezone.utc)
        ephs = list(select_ephemerides(records, at).values())[:6]
        rx_true = np.array([4_027_894.0, 307_045.7, 4_919_474.9])  # Europe
        c = C.SPEED_OF_LIGHT_M_S
        clock_bias_m = 8_700.0
        prs, txs = [], []
        for eph in ephs:
            t_tx = eph.t_oe + 600.0
            pos, _, clk = satellite_position(eph, t_tx)
            # geometric range with Sagnac (rotate sat during flight)
            r = np.linalg.norm(pos - rx_true)
            for _ in range(3):
                tof = r / c
                theta = C.OMEGA_E_DOT_RAD_S * tof
                rot = np.array([
                    [np.cos(theta), np.sin(theta), 0],
                    [-np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1],
                ])
                r = np.linalg.norm(rot @ pos - rx_true)
            prs.append(r + clock_bias_m - c * clk)
            txs.append(t_tx)
        return ephs, prs, txs, rx_true, clock_bias_m

    @pytest.mark.skipif(
        not os.path.exists(RINEX_PATH), reason="reference RINEX data absent"
    )
    def test_recovers_position(self):
        ephs, prs, txs, rx_true, bias = self._make_scene()
        sol = solve_pvt(prs, ephs, txs)
        assert sol is not None
        err = np.linalg.norm(sol.position_ecef_m - rx_true)
        assert err < 1.0, f"position error {err} m"
        assert sol.clock_bias_m == pytest.approx(bias, abs=1.0)
        assert np.max(np.abs(sol.residuals_m)) < 0.5
        assert 40.0 < sol.latitude_deg < 60.0
        assert sol.gdop < 20.0

    def test_underdetermined_returns_none(self):
        assert solve_pvt([1e7] * 3, [Ephemeris()] * 3, [0.0] * 3) is None

    def test_pseudorange_formation(self):
        tow = {5: 100.0, 9: 100.0 - 0.005 / C.SPEED_OF_LIGHT_M_S * C.SPEED_OF_LIGHT_M_S}
        prns, prs, txs = pseudoranges_from_tracking(
            {5: 100.0, 9: 99.93}, {}
        )
        assert prns == [5, 9]
        # PRN 9's signal left 70 ms earlier -> longer pseudorange
        assert prs[1] - prs[0] == pytest.approx(
            0.07 * C.SPEED_OF_LIGHT_M_S, rel=1e-9
        )


class TestBrdcDownload:
    def test_filename_matches_reference_bundle(self):
        import datetime

        from gnss_sdr.nav import brdc_filename, brdc_url

        # the reference's bundled file is day-of-year 333 of 2023
        day = datetime.date(2023, 11, 29)
        assert brdc_filename(day) == "BRDC00WRD_R_20233330000_01D_GN.rnx"
        assert brdc_url(day).endswith("/2023/333/BRDC00WRD_R_20233330000_01D_GN.rnx.gz")

    def test_offline_raises_connection_error(self, tmp_path):
        import datetime

        import pytest

        from gnss_sdr.nav import fetch_brdc

        with pytest.raises(ConnectionError, match="local RINEX"):
            fetch_brdc(datetime.date(2023, 11, 29), str(tmp_path),
                       base_url="https://127.0.0.1:1/nope", timeout_s=2.0)

    def test_existing_file_short_circuits(self, tmp_path):
        import datetime

        from gnss_sdr.nav import brdc_filename, fetch_brdc

        day = datetime.date(2023, 11, 29)
        existing = tmp_path / brdc_filename(day)
        existing.write_text("cached")
        assert fetch_brdc(day, str(tmp_path)) == str(existing)
