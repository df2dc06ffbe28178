"""Live nav decoding through the full receiver: RF samples in,
ephemeris out (BASELINE.md config 5 integration gate).

A synthetic satellite transmits genuine IS-GPS-200 LNAV frames
(parity-chained, t-bit constrained) over the code/carrier model; the
receiver must acquire cold, track, bit-sync, frame-sync, and decode the
ephemeris broadcast in subframes 1-3 — all through the public API.
"""
import numpy as np
import pytest

from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario
from gnss_sdr.nav import encode_frames, encode_words
from gnss_sdr.receiver import Receiver, SyntheticSource
from test_nav import sample_ephemeris

FS = 2_046_000.0


@pytest.fixture(scope="module")
def live_receiver():
    truth = sample_ephemeris()
    tow0 = 700  # subframe counts (x6 s)
    # dummy subframes carry random payloads: all-zero words produce
    # near-constant bit streams with too few sign flips for the
    # reference-style bit-sync histogram to reach its threshold
    rng = np.random.default_rng(99)
    dummy = lambda: rng.integers(0, 2, (8, 24)).astype(np.uint8)
    frames = [(4, tow0, dummy())] + [
        (sid, tow0 + sid, encode_words(truth, sid)) for sid in (1, 2, 3)
    ] + [(4, tow0 + 4, dummy())]
    nav_bits = encode_frames(frames)

    sat = SatelliteScenario(
        prn=truth.prn, doppler_hz=1234.0, code_phase_chips=0.0,
        amplitude=0.25, nav_bits=nav_bits,
    )
    # 25 s: dummy subframe (6 s) + SF1..3 (18 s) + lock margin
    source = SyntheticSource(
        [sat], FS, noise_std=1.0, seed=21,
        total_samples=int(25.0 * FS),
    )
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=AcqConfig(),
        track=TrackConfig(n_channels=4),
        block_ms=100,
    )
    rx = Receiver(cfg, source)
    rx.run()
    return rx, truth, tow0


class TestLiveNavDecode:
    def test_tracks_and_bit_syncs(self, live_receiver):
        rx, truth, _ = live_receiver
        assert set(rx.active) == {truth.prn}
        nav = rx.summary()["nav"]
        st = list(nav.values())[0]
        assert st["bit_synced"]
        assert st["frame_locked"]

    def test_subframes_decoded_with_correct_tow(self, live_receiver):
        rx, truth, tow0 = live_receiver
        ch = rx.active[truth.prn]
        chan_nav = rx.nav.channels[ch]
        sfs = chan_nav.frames.subframes
        assert len(sfs) >= 3
        ids = [sf.subframe_id for sf in sfs]
        tows = [sf.tow_counts for sf in sfs]
        # decoded subframes carry sequential TOW counts from the stream
        assert ids[:3] == [1, 2, 3] or ids[:4] == [4, 1, 2, 3][: len(ids)]
        for sf in sfs:
            assert sf.tow_counts == tow0 + sf.subframe_id or sf.subframe_id == 4

    def test_ephemeris_recovered(self, live_receiver):
        rx, truth, _ = live_receiver
        assert truth.prn in rx.nav.ephemerides, "ephemeris not assembled"
        eph = rx.nav.ephemerides[truth.prn]
        assert eph.week == truth.week
        assert eph.iode == truth.iode
        assert eph.sqrt_a == pytest.approx(truth.sqrt_a, abs=2**-19)
        assert eph.e == pytest.approx(truth.e, abs=2**-33)
        assert eph.m0 == pytest.approx(truth.m0, abs=2**-30 * np.pi)
        assert eph.t_oe == truth.t_oe
        assert eph.a_f0 == pytest.approx(truth.a_f0, abs=2**-31)

    def test_time_anchor_consistent(self, live_receiver):
        rx, truth, tow0 = live_receiver
        ch = rx.active[truth.prn]
        anchor = rx.nav.channels[ch].anchor
        assert anchor is not None
        # anchor tow = (HOW of last decoded subframe) - 6 s, refined by
        # the sub-chip code phase at the anchor epoch — within half a
        # chip (~0.5 us) of the 6 s subframe grid
        frac = anchor.tow_s % 6.0
        assert min(frac, 6.0 - frac) < 1e-5
        assert (tow0 - 1) * 6.0 <= anchor.tow_s <= (tow0 + 5) * 6.0
