"""Checkpoint/resume determinism: a restored receiver must continue the
stream exactly as the uninterrupted one (no reference counterpart —
SURVEY.md section 5 lists checkpointing as absent upstream)."""
import numpy as np

from gnss_sdr.config import ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario, synthesize
from gnss_sdr.receiver import ArraySource, Receiver
from gnss_sdr.utils import checkpoint

FS = 2_048_000.0


def make_rx(samples):
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        track=TrackConfig(n_channels=4),
        block_ms=20,
    )
    return Receiver(cfg, ArraySource(samples, FS))


def test_resume_is_deterministic(tmp_path):
    sats = [
        SatelliteScenario(prn=2, doppler_hz=1500.0, amplitude=0.3),
        SatelliteScenario(prn=17, doppler_hz=-2400.0, amplitude=0.25,
                          code_phase_chips=300.0),
    ]
    stream = synthesize(sats, int(0.6 * FS), FS, noise_std=1.0, seed=8)

    # uninterrupted run
    rx_full = make_rx(stream)
    rx_full.run(max_blocks=25)

    # checkpoint at block 10, restore into a new receiver, run 15 more
    rx_a = make_rx(stream)
    rx_a.run(max_blocks=10)
    ckpt = tmp_path / "rx.ckpt"
    checkpoint.save(rx_a, str(ckpt))
    consumed = checkpoint.consumed_samples(rx_a)

    rx_b = make_rx(stream[consumed:])
    checkpoint.restore(rx_b, str(ckpt))
    rx_b.run(max_blocks=15)

    assert set(rx_b.active) == set(rx_full.active) == {2, 17}
    # telemetry continues identically through the checkpoint boundary
    for t_full, t_res in zip(
        sorted(rx_full.telemetry.all_traces(), key=lambda t: t.prn),
        sorted(rx_b.telemetry.all_traces(), key=lambda t: t.prn),
    ):
        assert t_full.prn == t_res.prn
        n = min(len(t_full.i_p), len(t_res.i_p))
        np.testing.assert_allclose(
            np.asarray(t_full.i_p[:n]), np.asarray(t_res.i_p[:n]),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(t_full.carr_freq[:n]),
            np.asarray(t_res.carr_freq[:n]), rtol=1e-6,
        )
        np.testing.assert_array_equal(
            np.asarray(t_full.global_sample[:n]),
            np.asarray(t_res.global_sample[:n]),
        )


def test_version_gate(tmp_path):
    import pickle

    import pytest

    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps({"version": 999}))
    rx = make_rx(np.zeros(int(0.1 * FS), np.complex64))
    with pytest.raises(ValueError, match="version"):
        checkpoint.restore(rx, str(bad))
