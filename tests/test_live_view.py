"""Live view: periodic terminal/PNG refresh driven from Receiver.run.

Parity target: the reference's NavigationView window re-plotting at
~6 fps while the receiver runs (src/view.rs:37-116). Here the live
surface is a terminal status table + an atomically-replaced PNG,
paced by wall clock and driven by the run loop's on_block hook.
"""
import io
import os

import numpy as np
import pytest

from gnss_sdr.config import (AcqConfig, ReceiverConfig, RfConfig,
                                 TrackConfig)
from gnss_sdr.models import SatelliteScenario
from gnss_sdr.receiver import Receiver, SyntheticSource
from gnss_sdr.utils.live import LiveView

FS = 4_096_000.0
TRUTH = [
    (3, -2800.0, 101.5, 0.30),
    (14, 1200.0, 512.0, 0.25),
]


def make_receiver():
    sats = [
        SatelliteScenario(prn=p, doppler_hz=d, code_phase_chips=c,
                          amplitude=a)
        for p, d, c, a in TRUTH
    ]
    return Receiver(
        ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(non_coherent_ms=10),
            track=TrackConfig(n_channels=4),
            block_ms=20,
        ),
        SyntheticSource(sats, FS, noise_std=0.8, seed=5),
    )


class TestLiveView:
    def test_refresh_every_block_renders_table(self):
        rx = make_receiver()
        out = io.StringIO()
        view = LiveView(rx, interval_s=0.0, stream=out, ansi=False)
        rx.run(max_blocks=8, on_block=view)
        assert view.renders == 8
        text = out.getvalue()
        # both truth PRNs appear as rows with C/N0 and Doppler columns
        for prn, *_ in TRUTH:
            assert f"\n{prn:>4} " in text, f"PRN {prn} missing:\n{text}"
        assert "C/N0" in text and "Doppler" in text
        assert "fix:" in text

    def test_interval_paces_renders(self):
        rx = make_receiver()
        out = io.StringIO()
        # a huge interval -> only the first block renders
        view = LiveView(rx, interval_s=3600.0, stream=out, ansi=False)
        rx.run(max_blocks=5, on_block=view)
        assert view.renders == 1

    def test_ansi_mode_repaints_in_place(self):
        rx = make_receiver()
        out = io.StringIO()
        view = LiveView(rx, interval_s=0.0, stream=out, ansi=True)
        rx.run(max_blocks=2, on_block=view)
        # cursor-home + clear escape prefixes every frame
        assert out.getvalue().count("\x1b[H\x1b[J") == 2

    def test_png_refresh_atomic_replace(self, tmp_path):
        rx = make_receiver()
        png = tmp_path / "live.png"
        view = LiveView(rx, png_path=str(png), interval_s=0.0,
                        terminal=False)
        rx.run(max_blocks=3, on_block=view)
        assert png.exists() and png.stat().st_size > 1000
        # no stray tmp files left behind by the atomic replace
        assert [p.name for p in tmp_path.iterdir()] == ["live.png"]

    def test_doppler_column_tracks_truth(self):
        rx = make_receiver()
        view = LiveView(rx, interval_s=0.0, stream=io.StringIO(),
                        ansi=False)
        rx.run(max_blocks=15, on_block=view)
        text = view.render_text()
        row = next(ln for ln in text.splitlines()
                   if ln.startswith(f"{3:>4} "))
        doppler = float(row.split()[2])
        assert abs(doppler - (-2800.0)) < 100.0


class TestCliLiveFlags:
    def test_cli_live_png(self, tmp_path, capsys):
        from gnss_sdr.cli import main

        png = tmp_path / "dash.png"
        rc = main(["--blocks", "4", "--live-png", str(png),
                   "--live-fps", "1000", "--json"])
        assert rc == 0
        assert png.exists() and png.stat().st_size > 1000
