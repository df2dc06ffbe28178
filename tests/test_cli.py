"""CLI application tests (main.rs-parity entry point), in-process."""
import json

import pytest

from gnss_sdr.cli import main


def test_synthetic_scene_json(capsys):
    rc = main(["--blocks", "30", "--json"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(out)
    assert d["tracked_prns"] == [3, 9, 17]
    assert d["realtime_factor"] > 0


def test_config_file_run(tmp_path, capsys):
    import numpy as np

    from gnss_sdr.models import SatelliteScenario, synthesize_real_if_int8

    fs, f_if = 2_046_000.0, 511_500.0
    raw = synthesize_real_if_int8(
        [SatelliteScenario(prn=6, doppler_hz=750.0, amplitude=0.25)],
        int(0.25 * fs), fs, f_if, noise_std=1.0, scale=25.0,
    )
    cap = tmp_path / "cap.bin"
    cap.write_bytes(raw.tobytes())
    cfgfile = tmp_path / "rx.toml"
    cfgfile.write_text(f"""
block_ms = 20

[sdr]
driver = "file"
sample_rate_hz = {fs}
path = "{cap}"
file_format = "int8_real"

[rf]
freq_if_hz = {f_if}
output_sample_rate_hz = {fs}
enable_mixing = true
enable_dc_removal = true

[track]
n_channels = 4
""")
    rc = main(["--config", str(cfgfile), "--json", "--pvt"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["tracked_prns"] == [6]
    assert d["pvt"] is None  # no nav data in the capture


def test_missing_file_path_errors():
    import gnss_sdr.config as cfg_mod

    with pytest.raises(SystemExit, match="path required"):
        from gnss_sdr.cli import build_source

        build_source(cfg_mod.ReceiverConfig(
            sdr=cfg_mod.SdrConfig(driver="file", path="")
        ))


def test_dashboard_render(tmp_path, capsys):
    png = tmp_path / "dash.png"
    rc = main(["--blocks", "15", "--dashboard", str(png)])
    assert rc == 0
    assert png.exists() and png.stat().st_size > 10_000
