"""Live non-GPS nav decoding through the full receiver: RF samples in,
decoded ephemeris out, per constellation (VERDICT round-1 item 3).

Each scene transmits the constellation's genuine message structure
(Galileo I/NAV FEC+CRC pages, BeiDou D1 BCH+NH subframes, GLONASS
meander/time-mark strings) over the code/carrier model; the receiver
must acquire cold, track, symbol/bit-sync, frame-sync, and decode the
broadcast ephemeris — all through the public API. The GPS equivalent
gate lives in tests/test_nav_live.py.
"""
import numpy as np
import pytest

from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario
from gnss_sdr.models.constellation import (
    BEIDOU_B1I, GALILEO_E1B, GLONASS_L1OF,
)
from gnss_sdr.nav import bds_d1, glonass_nav as gn, inav
from gnss_sdr.receiver import Receiver, SyntheticSource
from test_nav_messages import (
    beidou_ephemeris, galileo_ephemeris, glonass_ephemeris,
)


@pytest.fixture(scope="module")
def galileo_live():
    truth = galileo_ephemeris()
    tow0 = 432_000.0
    # lead with word 5: a cold-starting receiver loses the first page
    nav_bits = inav.encode_symbol_stream(truth, wn=truth.week,
                                         tow0_s=tow0, n_pages=7,
                                         order=[5, 1, 2, 3, 4])
    fs = 4_092_000.0
    sat = SatelliteScenario(prn=truth.prn, doppler_hz=987.0,
                            amplitude=0.3, nav_bits=nav_bits,
                            signal=GALILEO_E1B)
    # word 5 (GST anchor) completes at nominal page 4 -> ~10 s
    source = SyntheticSource([sat], fs, noise_std=1.0, seed=31,
                             total_samples=int(13.0 * fs))
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
        acq=AcqConfig(signal="galileo_e1b", n_prn=36,
                      non_coherent_ms=16, detection_threshold=12.0),
        track=TrackConfig(signal="galileo_e1b", n_channels=4),
        block_ms=100,
    )
    rx = Receiver(cfg, source)
    rx.run()
    return rx, truth, tow0


class TestGalileoLive:
    def test_tracks_and_decodes_words(self, galileo_live):
        rx, truth, _ = galileo_live
        assert set(rx.active) == {truth.prn}
        st = list(rx.summary()["nav"].values())[0]
        assert st["bit_synced"] and st["frame_locked"]
        assert st["subframes"] >= 4          # I/NAV words seen

    def test_ephemeris_recovered(self, galileo_live):
        rx, truth, _ = galileo_live
        assert truth.prn in rx.nav.ephemerides
        eph = rx.nav.ephemerides[truth.prn]
        assert eph.system == "galileo"
        assert eph.sqrt_a == pytest.approx(truth.sqrt_a, abs=2**-19)
        assert eph.e == pytest.approx(truth.e, abs=2**-33)
        assert eph.m0 == pytest.approx(truth.m0, abs=2**-30 * np.pi)
        assert eph.t_oe == truth.t_oe
        assert eph.a_f0 == pytest.approx(truth.a_f0, abs=2**-33)
        assert eph.week == truth.week

    def test_gst_anchor_on_page_grid(self, galileo_live):
        rx, truth, tow0 = galileo_live
        anchor = rx.nav.channels[rx.active[truth.prn]].anchor
        assert anchor is not None
        # anchors stamp even-page starts: tow0 + 2k, code-phase refined
        frac = (anchor.tow_s - tow0) % 2.0
        assert min(frac, 2.0 - frac) < 1e-5


@pytest.fixture(scope="module")
def beidou_live():
    truth = beidou_ephemeris()
    sow0 = 345_600
    # lead with an almanac subframe (the cold start loses it)
    nav_bits = bds_d1.encode_bit_stream(truth, sow0=sow0, n_subframes=4,
                                        order=[5, 1, 2, 3])
    fs = 4_092_000.0
    sat = SatelliteScenario(prn=truth.prn, doppler_hz=-1543.0,
                            amplitude=0.3, nav_bits=nav_bits,
                            signal=BEIDOU_B1I)
    # SF5 (lost to cold start) + SF1-3 span 24 s; add lock margin
    source = SyntheticSource([sat], fs, noise_std=1.0, seed=32,
                             total_samples=int(25.0 * fs))
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
        acq=AcqConfig(signal="beidou_b1i", n_prn=37,
                      detection_threshold=10.0),
        track=TrackConfig(signal="beidou_b1i", n_channels=4),
        block_ms=100,
    )
    rx = Receiver(cfg, source)
    rx.run()
    return rx, truth, sow0


class TestBeidouLive:
    def test_tracks_and_decodes_subframes(self, beidou_live):
        rx, truth, _ = beidou_live
        assert set(rx.active) == {truth.prn}
        st = list(rx.summary()["nav"].values())[0]
        assert st["bit_synced"] and st["frame_locked"]
        assert st["subframes"] >= 3

    def test_ephemeris_recovered(self, beidou_live):
        rx, truth, _ = beidou_live
        assert truth.prn in rx.nav.ephemerides
        eph = rx.nav.ephemerides[truth.prn]
        assert eph.system == "beidou"
        assert eph.sqrt_a == pytest.approx(truth.sqrt_a, abs=2**-19)
        assert eph.e == pytest.approx(truth.e, abs=2**-33)
        assert eph.t_oe == truth.t_oe
        assert eph.week == truth.week
        assert eph.a_f0 == pytest.approx(truth.a_f0, abs=2**-32)

    def test_sow_anchor_on_subframe_grid(self, beidou_live):
        rx, truth, sow0 = beidou_live
        anchor = rx.nav.channels[rx.active[truth.prn]].anchor
        assert anchor is not None
        frac = (anchor.tow_s - sow0) % 6.0
        assert min(frac, 6.0 - frac) < 1e-5


@pytest.fixture(scope="module")
def glonass_live():
    truth = glonass_ephemeris()
    tk = 11_430.0
    # lead with an almanac string (the cold start loses it); tk is
    # the day time at which string 1 starts (2 s into the stream)
    nav_bits = gn.encode_bit_stream(truth, tk_s=tk, n_strings=6,
                                    order=[15, 1, 2, 3, 4])
    fs = 4_088_000.0
    k_chan = 2          # FDMA channel +2 -> pseudo-PRN 10 in range(-7,7)
    sat = SatelliteScenario(prn=10, doppler_hz=k_chan * 562_500.0 + 777.0,
                            amplitude=0.3, nav_bits=nav_bits,
                            signal=GLONASS_L1OF)
    # strings 1-4 span 8 s; time-mark sync adds ~2 strings of latency
    source = SyntheticSource([sat], fs, noise_std=1.0, seed=33,
                             total_samples=int(12.5 * fs))
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
        acq=AcqConfig(signal="glonass_l1of", n_prn=14,
                      fdma_spacing_hz=562_500.0,
                      fdma_channels=tuple(range(-7, 7))),
        track=TrackConfig(signal="glonass_l1of", n_channels=4),
        block_ms=100,
    )
    rx = Receiver(cfg, source)
    rx.run()
    return rx, truth, tk


class TestGlonassLive:
    def test_tracks_and_decodes_strings(self, glonass_live):
        rx, truth, _ = glonass_live
        assert set(rx.active) == {10}
        st = list(rx.summary()["nav"].values())[0]
        assert st["bit_synced"] and st["frame_locked"]
        assert st["subframes"] >= 4

    def test_ephemeris_recovered(self, glonass_live):
        rx, truth, _ = glonass_live
        assert 10 in rx.nav.ephemerides
        geph = rx.nav.ephemerides[10]
        assert geph.system == "glonass"
        assert np.allclose(geph.pos_m, truth.pos_m, atol=2.0)
        assert np.allclose(geph.vel_m_s, truth.vel_m_s, atol=1e-3)
        assert geph.t_b_s == truth.t_b_s
        assert abs(geph.tau_n - truth.tau_n) < 2e-9

    def test_string_anchor_on_2s_grid(self, glonass_live):
        rx, truth, tk = glonass_live
        anchor = rx.nav.channels[rx.active[10]].anchor
        assert anchor is not None
        frac = (anchor.tow_s - tk) % 2.0
        assert min(frac, 2.0 - frac) < 1e-5
