"""Slim telemetry wire (fused_runner run_blocks wire='slim') vs the
bit-exact f32 wire.

The slim wire ships per-epoch prompt I/Q as bf16, packed int8 flags,
int32 epoch starts and indices and f32 chip phase, and the diagnostic
columns (E/L correlators, loop errors, NCO rates) at a stride. Everything the nav/observables path consumes must
round-trip exactly or to bf16 tolerance; diagnostic columns follow the
documented stride-repeat semantics.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gnss_sdr.config import TrackConfig
from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.receiver import fused_runner as fr
from gnss_sdr.receiver import tracking as trk

FS = 2_046_000.0
N0 = GPS_L1CA.samples_per_code(FS)


def _mk_state(c):
    st = trk.init_state(c)
    for ch in range(c):
        st = trk.start_channel(
            st, ch, ch % 32, 800.0 + 150.0 * ch,
            N0 + 53 + 97 * ch, GPS_L1CA.code_rate_hz)
    return st


def _run_both(C=3, T=20, B=3):
    cfg = TrackConfig(n_channels=C, correlator="fused")
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes_s = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                          window=params.window)
    codes_rows = jnp.asarray(np.asarray(codes_s)[np.arange(C) % 32])
    block = T * N0
    history = 2 * N0 + 4096
    total = history + B * block
    sig = synthesize(
        [SatelliteScenario(prn=p + 1, doppler_hz=800.0 + 150.0 * p)
         for p in range(C)],
        total, FS, noise_std=0.2, seed=4)
    sre = jnp.asarray(np.real(sig).astype(np.float32))
    sim = jnp.asarray(np.imag(sig).astype(np.float32))

    outs = {}
    for wire in ("f32", "slim"):
        ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes_s, T,
                             history + block,
                             wire=wire)
        st, telems = ft.run_blocks(_mk_state(C), sre, sim,
                                   codes_rows, B)
        outs[wire] = (st, telems, ft)
    return outs


class TestSlimWire:
    def test_exact_fields_roundtrip(self):
        outs = _run_both()
        _, ref, _ = outs["f32"]
        _, slim, _ = outs["slim"]
        for b, (a, s) in enumerate(zip(ref, slim)):
            # lifecycle + timing: EXACT (nav correctness depends on it)
            np.testing.assert_array_equal(a.processed, s.processed)
            np.testing.assert_array_equal(a.locked, s.locked)
            np.testing.assert_array_equal(a.lost_event, s.lost_event)
            np.testing.assert_array_equal(a.start_offset,
                                          s.start_offset)
            np.testing.assert_array_equal(a.epoch_index, s.epoch_index)
            # chip phase ships f32: exact
            np.testing.assert_array_equal(a.chip_phase, s.chip_phase)

    def test_prompt_iq_bf16(self):
        outs = _run_both()
        _, ref, _ = outs["f32"]
        _, slim, _ = outs["slim"]
        for a, s in zip(ref, slim):
            for f in ("i_p", "q_p"):
                x, y = getattr(a, f), getattr(s, f)
                scale = np.maximum(np.abs(x), 1.0)
                # bf16 mantissa: 8 bits -> rel err <= 2^-8
                assert (np.abs(x - y) / scale).max() < 2 ** -7.5, f
                # nav bit signs must survive where the value is
                # meaningfully nonzero
                big = np.abs(x) > 8.0 * np.abs(x).mean()
                assert np.array_equal(np.sign(x[big]), np.sign(y[big]))

    def test_stride_semantics(self):
        outs = _run_both()
        _, ref, _ = outs["f32"]
        _, slim, ft = outs["slim"]
        s_stride = ft.wire_stride
        assert ft.t_epochs % s_stride == 0
        for a, s in zip(ref, slim):
            # at stride points the diagnostic columns are exact f32
            # (rates) or bf16 (E/L, errors); between points they repeat
            np.testing.assert_array_equal(
                a.carr_freq[::s_stride], s.carr_freq[::s_stride])
            np.testing.assert_array_equal(
                a.code_rate[::s_stride], s.code_rate[::s_stride])
            rep = np.repeat(a.carr_freq[::s_stride], s_stride, axis=0)
            np.testing.assert_array_equal(s.carr_freq,
                                          rep[: a.carr_freq.shape[0]])
            x = a.i_e[::s_stride]
            y = s.i_e[::s_stride]
            scale = np.maximum(np.abs(x), 1.0)
            assert (np.abs(x - y) / scale).max() < 2 ** -7.5

    def test_ledger_identical(self):
        """The wire format only changes the telemetry download — the
        device ledger (and thus tracking itself) must be bit-identical."""
        outs = _run_both()
        st_ref = outs["f32"][0]
        st_slim = outs["slim"][0]
        for f in st_ref._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(st_ref, f)),
                np.asarray(getattr(st_slim, f)), err_msg=f)

    def test_slim2_requires_mxu(self):
        cfg = TrackConfig(n_channels=2, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes_s = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                              window=params.window)
        # an unknown wire is an error, not a silent downgrade
        with pytest.raises(ValueError, match="wire"):
            fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes_s, 20,
                            2 * N0 + 4096 + 20 * N0, wire="slim2")

    def test_receiver_auto_wire_cpu_is_f32(self):
        from gnss_sdr import ReceiverConfig, RfConfig
        from gnss_sdr.config import AcqConfig
        from gnss_sdr.receiver import Receiver, SyntheticSource

        src = SyntheticSource(
            [SatelliteScenario(prn=1, doppler_hz=500.0)], FS,
            noise_std=0.5, seed=1, total_samples=int(0.1 * FS))
        rx = Receiver(
            ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                acq=AcqConfig(),
                track=TrackConfig(n_channels=2, correlator="fused"),
                block_ms=20,
            ),
            src,
        )
        # CPU backend resolves "auto" to the bit-exact format
        assert rx.fused.wire == "f32"
