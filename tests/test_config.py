"""Config system tests (reference: src/config/app_config.rs + compile-time
statics promoted to config per SURVEY.md section 5)."""
import dataclasses

import pytest

from gnss_sdr import config as cfg_mod
from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, SdrConfig


def test_defaults_match_reference_operating_points():
    cfg = ReceiverConfig()
    # reference do_acquisition.rs:20-23
    assert cfg.acq.doppler_span_hz == 14_000.0
    assert cfg.acq.doppler_step_hz == 500.0
    assert cfg.acq.doppler_bins == 29
    assert cfg.acq.non_coherent_ms == 10
    assert cfg.acq.detection_threshold == 7.0
    # reference do_tracking.rs:16-29
    assert cfg.track.n_channels == 15
    assert cfg.track.lock_threshold == 15.0
    assert cfg.track.max_lost_epochs == 20
    assert cfg.track.pll_bandwidth_hz == 25.0
    assert cfg.track.dll_bandwidth_hz == 2.0
    assert cfg.track.early_late_chips == 0.5


def test_derived_if():
    # IF = center - L1 (reference app_config.rs:48)
    cfg = ReceiverConfig(sdr=SdrConfig(center_freq_hz=1_579_550_400.0))
    assert cfg.f_if_hz == pytest.approx(4_130_400.0)
    cfg2 = ReceiverConfig(rf=RfConfig(freq_if_hz=123.0))
    assert cfg2.f_if_hz == 123.0


def test_frozen_and_hashable():
    cfg = ReceiverConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.block_ms = 5
    hash(cfg.acq)  # usable as a jit static argument


def test_toml_roundtrip(tmp_path):
    p = tmp_path / "rx.toml"
    p.write_text(
        """
block_ms = 40

[sdr]
driver = "file"
center_freq_hz = 1579550400.0
sample_rate_hz = 16367600.0
path = "capture.bin"

[rf]
output_sample_rate_hz = 16367600.0

[acq]
doppler_span_hz = 10000.0
non_coherent_ms = 5

[track]
n_channels = 8
"""
    )
    cfg = cfg_mod.from_toml(str(p))
    assert cfg.block_ms == 40
    assert cfg.sdr.path == "capture.bin"
    assert cfg.acq.doppler_bins == 21
    assert cfg.track.n_channels == 8
    assert cfg.f_if_hz == pytest.approx(4_130_400.0)


def test_toml_unknown_key_rejected(tmp_path):
    # strictness guard against the reference's silent serde key mismatch
    # (SURVEY.md section 5)
    p = tmp_path / "bad.toml"
    p.write_text("[sdr]\ncenter_frequency_hz = 1.0\n")
    with pytest.raises(ValueError, match="center_frequency_hz"):
        cfg_mod.from_toml(str(p))


def test_ladder_presets_construct():
    from gnss_sdr import presets

    assert presets.ladder1_single_sat_capture().acq.pad_fft
    assert presets.ladder2_eight_channel().track.n_channels == 8
    l3 = presets.ladder3_galileo()
    assert set(l3) == {"gps_l1ca", "galileo_e1b"}
    l4 = presets.ladder4_multi_constellation()
    assert sum(c.track.n_channels for c in l4.values()) == 32
    assert presets.ladder5_full_pipeline().pvt.enable
