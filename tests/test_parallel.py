"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The determinism gate from BASELINE.md: 1-shard vs N-shard runs must
produce (bit-)identical correlator outputs. The reference has no
distributed story at all (SURVEY.md section 4 "no multi-node story").
"""
import jax.numpy as jnp
import numpy as np
import pytest

from gnss_sdr import parallel
from gnss_sdr.config import TrackConfig
from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
from gnss_sdr.ops import pcps
from gnss_sdr.receiver import tracking as trk

FS = 2_048_000.0
N = GPS_L1CA.samples_per_code(FS)  # 2048
CODE_RATE = GPS_L1CA.code_rate_hz


def test_mesh_construction():
    m = parallel.make_mesh(n_time=2, n_channel=4)
    assert m.shape == {"time": 2, "channel": 4}
    with pytest.raises(ValueError):
        parallel.make_mesh(n_time=16, n_channel=16)


class TestChannelShardedTracking:
    def test_bit_identical_to_single_device(self):
        cfg = TrackConfig(n_channels=16)
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes = trk.make_code_table(GPS_L1CA, 32)

        sats = [
            SatelliteScenario(prn=p, doppler_hz=300.0 * p,
                              code_phase_chips=13.0 * p)
            for p in range(1, 9)
        ]
        sig = synthesize(sats, 40 * N, FS, noise_std=0.5, seed=5)
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)

        state = trk.init_state(16)
        for ch in range(8):
            state = trk.start_channel(
                state, ch, ch, 300.0 * (ch + 1), 0, CODE_RATE
            )
        codes_ch = codes[np.maximum(np.asarray(state.prn_idx), 0)]

        ref_state, ref_telem = trk.track_block(
            params, codes_ch, state, re, im, 30
        )

        mesh = parallel.make_mesh(n_time=1, n_channel=8)
        sh_state, sh_telem = parallel.sharded_track_block(
            mesh, params, codes_ch, state, re, im, 30
        )

        for name in ("i_p", "q_p", "i_e", "q_l", "carr_freq", "code_rate"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref_telem, name)),
                np.asarray(getattr(sh_telem, name)),
                err_msg=f"telemetry field {name} differs under sharding",
            )
        np.testing.assert_array_equal(
            np.asarray(ref_state.carr_acc), np.asarray(sh_state.carr_acc)
        )
        np.testing.assert_array_equal(
            np.asarray(ref_state.offset), np.asarray(sh_state.offset)
        )


class TestShardedAcquisition:
    @pytest.fixture(scope="class")
    def scene(self):
        sats = [
            SatelliteScenario(prn=6, doppler_hz=2500.0, amplitude=0.3),
            SatelliteScenario(prn=24, doppler_hz=-4100.0, amplitude=0.25),
        ]
        x = synthesize(sats, 8 * N, FS, noise_std=1.0, seed=9)
        code_ffts = pcps.code_replica_ffts(GPS_L1CA, FS, 32)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        ref = pcps.pcps_search(x, code_ffts, grid, fs_hz=FS, n_int=8)
        return x, code_ffts, grid, ref

    def test_prn_sharded_matches(self, scene):
        x, code_ffts, grid, ref = scene
        mesh = parallel.make_mesh(n_time=1, n_channel=8)
        res = parallel.sharded_pcps_search(
            mesh, x, code_ffts, grid, fs_hz=FS, n_int=8
        )
        np.testing.assert_array_equal(
            np.asarray(ref.detected), np.asarray(res.detected)
        )
        np.testing.assert_allclose(
            np.asarray(ref.ratio), np.asarray(res.ratio), rtol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(ref.code_phase_samples),
            np.asarray(res.code_phase_samples),
        )

    @pytest.mark.parametrize("n_time", [2, 4, 8])
    def test_time_sharded_matches(self, scene, n_time):
        x, code_ffts, grid, ref = scene
        mesh = parallel.make_mesh(n_time=n_time, n_channel=1)
        res = parallel.time_sharded_pcps_search(
            mesh, x, code_ffts, grid, fs_hz=FS, n_int=8
        )
        np.testing.assert_array_equal(
            np.asarray(ref.detected), np.asarray(res.detected)
        )
        # fp sum order differs across shards: allow tiny tolerance
        np.testing.assert_allclose(
            np.asarray(ref.ratio), np.asarray(res.ratio), rtol=1e-4
        )
        np.testing.assert_array_equal(
            np.asarray(ref.code_phase_samples),
            np.asarray(res.code_phase_samples),
        )
        assert set(np.where(np.asarray(res.detected))[0] + 1) == {6, 24}

    def test_time_sharded_indivisible_raises(self, scene):
        x, code_ffts, grid, _ = scene
        mesh = parallel.make_mesh(n_time=3, n_channel=1)
        with pytest.raises(ValueError):
            parallel.time_sharded_pcps_search(
                mesh, x, code_ffts, grid, fs_hz=FS, n_int=8
            )

    def test_grid_mesh_2x4(self, scene):
        """Combined time x channel mesh: PRNs sharded 4-way, time 2-way."""
        x, code_ffts, grid, ref = scene
        mesh = parallel.make_mesh(n_time=2, n_channel=4)
        res = parallel.time_sharded_pcps_search(
            mesh, x, code_ffts, grid, fs_hz=FS, n_int=8
        )
        np.testing.assert_array_equal(
            np.asarray(ref.detected), np.asarray(res.detected)
        )


class TestDistributedGlue:
    def test_partition_covers_stream_exactly_once(self):
        shards = parallel.partition_stream(1_000_000, 4, halo=5000)
        assert [s.core_start for s in shards] == [0, 250000, 500000, 750000]
        assert all(s.core_count == 250000 for s in shards)
        # halos: all but the last host read past their boundary
        assert [s.halo for s in shards] == [5000, 5000, 5000, 0]
        assert shards[1].count == 255000 and shards[3].count == 250000
        # cores tile the stream exactly
        covered = sum(s.core_count for s in shards)
        assert covered == 1_000_000

    def test_partition_validation(self):
        with pytest.raises(ValueError, match="divisible"):
            parallel.partition_stream(1001, 4, halo=10)
        with pytest.raises(ValueError, match="halo"):
            parallel.partition_stream(1000, 4, halo=300)

    def test_merge_dedups_halo_events(self):
        shards = parallel.partition_stream(1000, 2, halo=100)
        ev_a = [{"global_sample": 10}, {"global_sample": 520}]  # 520 in halo
        ev_b = [{"global_sample": 520}, {"global_sample": 900}]
        merged = parallel.merge_shard_results(shards, [ev_a, ev_b])
        assert [e["global_sample"] for e in merged] == [10, 520, 900]

    def test_single_host_noop(self):
        assert not parallel.initialize_from_env(num_processes=1)
        shards = parallel.partition_stream(1000, 1, halo=0)
        assert shards[0].count == 1000 and shards[0].halo == 0


class TestShardedReceiver:
    def test_receiver_on_mesh_matches_unsharded(self):
        """Full Receiver with ParallelConfig(channel_axis=4) over the
        virtual device mesh produces the same results as unsharded —
        the receiver-level multi-chip determinism gate."""
        from gnss_sdr.config import (
            ParallelConfig, ReceiverConfig, RfConfig, TrackConfig,
        )
        from gnss_sdr.models import SatelliteScenario, synthesize
        from gnss_sdr.receiver import ArraySource, Receiver

        fs = 2_048_000.0
        sats = [
            SatelliteScenario(prn=3, doppler_hz=1200.0, amplitude=0.3),
            SatelliteScenario(prn=22, doppler_hz=-2600.0, amplitude=0.25,
                              code_phase_chips=700.0),
        ]
        stream = synthesize(sats, int(0.4 * fs), fs, noise_std=1.0, seed=2)

        def run(par):
            cfg = ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
                track=TrackConfig(n_channels=8),
                parallel=par,
                block_ms=20,
            )
            rx = Receiver(cfg, ArraySource(stream, fs))
            rx.run()
            return rx

        rx_a = run(ParallelConfig())                      # unsharded
        rx_b = run(ParallelConfig(channel_axis=4))        # 4-way mesh
        assert rx_b.mesh is not None
        assert set(rx_a.active) == set(rx_b.active) == {3, 22}
        for ta, tb in zip(
            sorted(rx_a.telemetry.all_traces(), key=lambda t: t.prn),
            sorted(rx_b.telemetry.all_traces(), key=lambda t: t.prn),
        ):
            np.testing.assert_allclose(
                np.asarray(ta.carr_freq), np.asarray(tb.carr_freq),
                rtol=1e-6,
            )
            np.testing.assert_array_equal(
                np.asarray(ta.global_sample), np.asarray(tb.global_sample)
            )

    def test_indivisible_channels_rejected(self):
        from gnss_sdr.config import (
            ParallelConfig, ReceiverConfig, TrackConfig,
        )
        from gnss_sdr.receiver import ArraySource, Receiver

        with pytest.raises(ValueError, match="divisible"):
            Receiver(
                ReceiverConfig(track=TrackConfig(n_channels=15),
                               parallel=ParallelConfig(channel_axis=4)),
                ArraySource(np.zeros(4096, np.complex64), 2_048_000.0),
            )


class TestFusedOnMesh:
    def test_channel_sharded_fused_bit_identical(self):
        """The fused (flagship) tracking step channel-sharded over a
        4-device mesh must be BIT-IDENTICAL to the 1-device run — the
        kernel is pure data parallelism over channels
        (parallel.shard_fused_step)."""
        from gnss_sdr.config import TrackConfig
        from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
        from gnss_sdr.receiver import fused_runner as fr
        from gnss_sdr.receiver import tracking as trk

        fs = 2_046_000.0
        n0 = GPS_L1CA.samples_per_code(fs)
        C, T = 8, 40
        cfg = TrackConfig(n_channels=C, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, fs)
        codes_s = trk.make_sampled_code_table(GPS_L1CA, fs, 32,
                                              window=params.window)
        codes_rows = jnp.asarray(np.asarray(codes_s)[np.arange(C) % 32])
        buf_len = (T + 4) * n0 + 8192
        sig = synthesize(
            [SatelliteScenario(prn=p + 1, doppler_hz=700.0 + 140.0 * p)
             for p in range(C)],
            buf_len, fs, noise_std=0.3, seed=6)
        bre = jnp.asarray(np.real(sig), jnp.float32)
        bim = jnp.asarray(np.imag(sig), jnp.float32)

        def mk_state():
            st = trk.init_state(C)
            for ch in range(C):
                st = trk.start_channel(
                    st, ch, ch % 32, 700.0 + 140.0 * ch,
                    n0 + 29 + 83 * ch, GPS_L1CA.code_rate_hz)
            return st

        ft1 = fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes_s, T,
                              buf_len)
        st1, t1 = ft1.run_block(mk_state(), bre, bim, codes_rows)

        mesh = parallel.make_mesh(n_time=1, n_channel=4)
        ftm = fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes_s, T,
                              buf_len, mesh=mesh)
        stm, tm = ftm.run_block(mk_state(), bre, bim, codes_rows)

        for f in trk.EpochTelemetry._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(t1, f)), np.asarray(getattr(tm, f)),
                err_msg=f"telemetry field {f}")
        for f in trk.ChannelState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(st1, f)), np.asarray(getattr(stm, f)),
                err_msg=f"state field {f}")

    def test_run_blocks_on_mesh(self):
        """The multi-block scan composes with the channel-sharded step:
        same results as the unsharded scan."""
        from gnss_sdr.config import TrackConfig
        from gnss_sdr.models import GPS_L1CA, SatelliteScenario, synthesize
        from gnss_sdr.receiver import fused_runner as fr
        from gnss_sdr.receiver import tracking as trk

        fs = 2_046_000.0
        n0 = GPS_L1CA.samples_per_code(fs)
        C, T, B = 4, 20, 3
        cfg = TrackConfig(n_channels=C, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, fs)
        codes_s = trk.make_sampled_code_table(GPS_L1CA, fs, 32,
                                              window=params.window)
        codes_rows = jnp.asarray(np.asarray(codes_s)[np.arange(C) % 32])
        block = T * n0
        history = 2 * n0 + 4096
        sig = synthesize(
            [SatelliteScenario(prn=p + 1, doppler_hz=600.0 + 170.0 * p)
             for p in range(C)],
            history + B * block, fs, noise_std=0.3, seed=8)
        sre = jnp.asarray(np.real(sig), jnp.float32)
        sim = jnp.asarray(np.imag(sig), jnp.float32)

        def mk_state():
            st = trk.init_state(C)
            for ch in range(C):
                st = trk.start_channel(
                    st, ch, ch % 32, 600.0 + 170.0 * ch,
                    n0 + 41 + 77 * ch, GPS_L1CA.code_rate_hz)
            return st

        ft1 = fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes_s, T,
                              history + block)
        st1, t1s = ft1.run_blocks(mk_state(), sre, sim, codes_rows, B)

        mesh = parallel.make_mesh(n_time=1, n_channel=4)
        ftm = fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes_s, T,
                              history + block,
                              mesh=mesh)
        stm, tms = ftm.run_blocks(mk_state(), sre, sim, codes_rows, B)

        for b, (a, m) in enumerate(zip(t1s, tms)):
            np.testing.assert_array_equal(
                np.asarray(a.i_p), np.asarray(m.i_p),
                err_msg=f"block {b}")
        np.testing.assert_array_equal(st1.offset, stm.offset)
        np.testing.assert_array_equal(st1.chip_int, stm.chip_int)
