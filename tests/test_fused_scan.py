"""Multi-block device-resident scan (FusedTracker.run_blocks) vs the
per-block host-re-anchored path (run_block + rebase).

run_blocks folds the host's per-block re-anchor/absorb into a lax.scan
so the steady-state receiver syncs the host once per n_blocks blocks
(the reference instead streams continuously through its SPMC ring,
multicast_ring_buffer.rs:36-132 — here the ring's role is played by the
device-resident ledger). The scan ledger carries chip phase as
(int32, f32 frac) instead of the host's u32, so telemetry may differ by
sub-LSB quantization — but lock/offset/epoch bookkeeping must agree
exactly and correlator outputs to ~1e-3 relative.
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


def _mk_state(C):
    st = trk.init_state(C)
    for ch in range(C):
        st = trk.start_channel(
            st, ch, ch % 32, 800.0 + 150.0 * ch,
            N0 + 53 + 97 * ch, GPS_L1CA.code_rate_hz)
    return st


class TestRunBlocks:
    def test_matches_per_block_path(self):
        C, T, B = 3, 20, 4
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
        sre = np.real(sig).astype(np.float32)
        sim = np.imag(sig).astype(np.float32)

        ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes_s, T,
                             history + block)

        # reference: B x (run_block over a rolling window + rebase)
        st_ref = _mk_state(C)
        telems_ref = []
        for b in range(B):
            w_re = jnp.asarray(sre[b * block: b * block + history + block])
            w_im = jnp.asarray(sim[b * block: b * block + history + block])
            st_ref, tl = ft.run_block(st_ref, w_re, w_im, codes_rows)
            telems_ref.append(tl)
            st_ref = trk.rebase(st_ref, block)

        # scan path: one call over the whole span
        st_scan, telems_scan = ft.run_blocks(
            _mk_state(C), jnp.asarray(sre), jnp.asarray(sim),
            codes_rows, B)

        for b, (a, s) in enumerate(zip(telems_ref, telems_scan)):
            assert np.array_equal(a.processed, s.processed), f"block {b}"
            np.testing.assert_array_equal(
                a.start_offset, s.start_offset, err_msg=f"block {b}")
            np.testing.assert_array_equal(
                a.epoch_index, s.epoch_index, err_msg=f"block {b}")
            for f in ("i_p", "q_p", "i_e", "q_l", "carr_freq",
                      "code_rate"):
                x, y = getattr(a, f), getattr(s, f)
                scale = max(1.0, np.abs(x).max())
                assert np.abs(x - y).max() / scale < 2e-3, \
                    f"block {b} field {f}"
            np.testing.assert_allclose(
                s.chip_phase, a.chip_phase, atol=2e-4,
                err_msg=f"block {b} chip_phase")

        # final ledger
        np.testing.assert_array_equal(st_scan.active, st_ref.active)
        np.testing.assert_array_equal(st_scan.offset, st_ref.offset)
        np.testing.assert_array_equal(st_scan.epochs, st_ref.epochs)
        np.testing.assert_array_equal(st_scan.chip_int, st_ref.chip_int)
        np.testing.assert_allclose(
            st_scan.carr_freq, st_ref.carr_freq, rtol=1e-4)
        np.testing.assert_allclose(
            st_scan.code_rate, st_ref.code_rate, rtol=1e-6)
        # chip frac: u32 ledger vs (i32, f32) ledger quantization
        df = (st_scan.chip_frac_u32.astype(np.float64)
              - st_ref.chip_frac_u32.astype(np.float64)) / 2**32
        assert np.abs(df).max() < 1e-3

    def test_receiver_scan_matches_per_block(self):
        """Receiver.run(scan_blocks=4) must produce the same tracking
        outcome as the per-block loop: same tracked set, same epoch
        counts, matching Doppler and telemetry trace lengths."""
        from gnss_sdr import ReceiverConfig, RfConfig, TrackConfig
        from gnss_sdr.config import AcqConfig
        from gnss_sdr.receiver import Receiver, SyntheticSource

        FS2 = 2_046_000.0

        def build():
            src = SyntheticSource(
                [SatelliteScenario(prn=5, doppler_hz=2100.0,
                                   amplitude=0.35),
                 SatelliteScenario(prn=9, doppler_hz=-1500.0,
                                   amplitude=0.35)],
                FS2, noise_std=1.0, seed=13)
            return Receiver(ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS2),
                # steady mode at 2 tracked so the scan path engages
                acq=AcqConfig(steady_threshold=2),
                track=TrackConfig(n_channels=4, correlator="fused"),
                block_ms=20), src)

        rx_a = build()
        sum_a = rx_a.run(max_blocks=24)
        rx_b = build()
        sum_b = rx_b.run(max_blocks=24, scan_blocks=4)

        assert sum_a["tracked_prns"] == sum_b["tracked_prns"] == [5, 9]
        assert sum_b["blocks"] == sum_a["blocks"] == 24
        # the scan path must actually have run: fewer track-stage calls
        # than blocks (spans batch 4 blocks per call)
        calls_b = sum_b["stage_timing"]["track"]["calls"]
        assert calls_b < sum_a["stage_timing"]["track"]["calls"]
        ch_a = {c["prn"]: c for c in sum_a["channels"]}
        ch_b = {c["prn"]: c for c in sum_b["channels"]}
        for prn in (5, 9):
            assert ch_a[prn]["epochs"] == ch_b[prn]["epochs"]
            assert abs(ch_a[prn]["last_doppler_hz"]
                       - ch_b[prn]["last_doppler_hz"]) < 1.0
            assert ch_b[prn]["locked_fraction"] > 0.95

    def test_deferred_channel_passes_through(self):
        """A channel whose offset exceeds max_offset must defer (state
        untouched that block) and catch up after the implicit rebase —
        across a scan boundary."""
        C, T, B = 2, 20, 3
        cfg = TrackConfig(n_channels=C, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes_s = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                              window=params.window)
        codes_rows = jnp.asarray(np.asarray(codes_s)[np.arange(C) % 32])
        block = T * N0
        history = 2 * N0 + 4096
        total = history + B * block
        sig = synthesize([SatelliteScenario(prn=1, doppler_hz=900.0),
                          SatelliteScenario(prn=2, doppler_hz=1100.0)],
                         total, FS, noise_std=0.2, seed=9)
        ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes_s, T,
                             history + block)
        st = trk.init_state(C)
        st = trk.start_channel(st, 0, 0, 900.0, N0 + 11,
                               GPS_L1CA.code_rate_hz)
        # channel 1 starts past max_offset: deferred in block 0
        st = trk.start_channel(st, 1, 1, 1100.0,
                               int(ft.max_offset) + 5,
                               GPS_L1CA.code_rate_hz)
        st_out, telems = ft.run_blocks(
            st, jnp.asarray(np.real(sig), np.float32),
            jnp.asarray(np.imag(sig), np.float32), codes_rows, B)
        assert not telems[0].processed[:, 1].any()     # deferred
        assert telems[1].processed[:, 1].all()         # caught up
        assert telems[0].processed[:, 0].all()
        assert bool(st_out.active[0]) and bool(st_out.active[1])
        assert int(st_out.epochs[1]) == (B - 1) * T
