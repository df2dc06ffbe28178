"""Worker for tools/scaling_probe.py (strong-scaling measurement).

Launched as
``python _scaling_worker.py <coordinator|-> <n_procs> <pid> <n_int>
<iters> <out.json>``, optionally under ``taskset`` so each process owns
a disjoint core set (the honest stand-in for "one host each").

Every process times the SAME global job — a full 32-PRN x 29-bin PCPS
search over ``n_int`` ms of signal — time-sharded over the global mesh
(2 virtual CPU devices per process, gloo collectives across processes,
exactly the runtime tests/test_distributed.py proves correct). Equal
work, more processes: classic strong scaling.
"""
import json
import sys
import time


def main() -> None:
    coordinator, n_procs, pid, n_int, iters, out_path = (
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

    from gnss_sdr.models import GPS_L1CA, signal
    from gnss_sdr.ops import pcps

    fs = 2_046_000.0
    n0 = GPS_L1CA.samples_per_code(fs)
    n_time = 2 * n_procs
    assert n_int % n_time == 0

    scene = [
        signal.SatelliteScenario(prn=5, doppler_hz=1500.0,
                                 code_phase_chips=210.0).with_code_doppler(),
        signal.SatelliteScenario(prn=17, doppler_hz=-2500.0,
                                 code_phase_chips=700.5).with_code_doppler(),
    ]
    samples = signal.synthesize(scene, n_int * n0, fs, noise_std=4.0, seed=7)
    code_ffts = pcps.code_replica_ffts(GPS_L1CA, fs, 32)
    grid = jnp.asarray(pcps.doppler_grid(7_000.0, 500.0))

    mesh = parallel.global_mesh(n_time=n_time)
    sharded = jax.make_array_from_callback(
        samples.shape,
        NamedSharding(mesh, P(parallel.TIME_AXIS)),
        lambda idx: samples[idx],
    )

    def run():
        out = parallel.time_sharded_pcps_search(
            mesh, sharded, code_ffts, grid, fs_hz=fs, n_int=n_int
        )
        jax.block_until_ready(out)
        return out

    out = run()   # compile + warm
    run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)

    detected = sorted(
        int(p) + 1 for p in np.flatnonzero(jax.device_get(out.detected))
    )
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({
                "n_procs": n_procs,
                "n_int_ms": n_int,
                "median_s": sorted(times)[len(times) // 2],
                "min_s": min(times),
                "times_s": times,
                "detected_prns": detected,
            }, f)
    print(f"proc {pid}/{n_procs}: median "
          f"{sorted(times)[len(times) // 2] * 1e3:.1f} ms, "
          f"detected {detected}")


if __name__ == "__main__":
    main()
