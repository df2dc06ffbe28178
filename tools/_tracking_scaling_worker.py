"""Worker for tools/tracking_scaling_probe.py.

Same protocol as _scaling_worker.py (taskset-pinned processes, gloo
collectives, equal TOTAL work) but for TRACKING: a 32-channel
track_block scan with the channel axis sharded over the global mesh —
the dominant-compute axis the reference scales with a rayon pool
(do_tracking.rs:364-371). Channel sharding has zero steady-state
collectives; the probe proves the sharded program actually strong-
scales on real added silicon, process boundary included.
"""
import json
import sys
import time


def main() -> None:
    coordinator, n_procs, pid, n_epochs, iters, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
        int(sys.argv[4]), int(sys.argv[5]), sys.argv[6],
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from gnss_sdr import parallel

    if n_procs > 1:
        assert parallel.initialize_from_env(
            coordinator_address=coordinator,
            num_processes=n_procs,
            process_id=pid,
        )
        assert jax.device_count() == 2 * n_procs

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gnss_sdr.config import TrackConfig
    from gnss_sdr.models import GPS_L1CA
    from gnss_sdr.receiver import tracking as trk

    fs = 2_046_000.0
    spec = GPS_L1CA
    n0 = spec.samples_per_code(fs)
    c = 32
    n_ch_axis = 2 * n_procs
    mesh = parallel.global_mesh(n_time=1, n_channel=n_ch_axis)

    cfg = TrackConfig(n_channels=c)
    params = trk.TrackParams.create(cfg, spec, fs)
    codes = np.asarray(trk.make_code_table(spec, 32))

    state = trk.init_state(c)
    for ch in range(c):
        state = trk.start_channel(
            state, ch, ch % 32, 1000.0 + 10.0 * ch, n0 + ch * 13,
            spec.code_rate_hz)
    state = jax.tree.map(np.asarray, state)
    codes_ch = codes[np.maximum(np.asarray(state.prn_idx), 0)]

    rng = np.random.default_rng(0)
    block_len = (n_epochs + 1) * n0 + params.window
    block_re = rng.standard_normal(block_len).astype(np.float32)
    block_im = rng.standard_normal(block_len).astype(np.float32)

    ch_sh = NamedSharding(mesh, P(parallel.CHANNEL_AXIS))
    ch2_sh = NamedSharding(mesh, P(parallel.CHANNEL_AXIS, None))
    rep = NamedSharding(mesh, P())

    def put(arr, sh):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    state_g = jax.tree.map(lambda x: put(x, ch_sh), state)
    codes_g = put(codes_ch, ch2_sh)
    bre_g = put(block_re, rep)
    bim_g = put(block_im, rep)

    def run(st):
        st, telem = trk.track_block(
            params, codes_g, st, bre_g, bim_g, n_epochs)
        jax.block_until_ready(telem.power)
        return st, telem

    st, telem = run(state_g)      # compile + warm
    run(state_g)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run(state_g)
        times.append(time.perf_counter() - t0)

    med = sorted(times)[len(times) // 2]
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({
                "n_procs": n_procs,
                "channels": c,
                "n_epochs": n_epochs,
                "median_s": med,
                "min_s": min(times),
                "times_s": times,
            }, f)
    print(f"proc {pid}/{n_procs}: median {med * 1e3:.1f} ms "
          f"for {c}ch x {n_epochs} epochs")


if __name__ == "__main__":
    main()
