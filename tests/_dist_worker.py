"""Subprocess worker for the real 2-process jax.distributed test.

Launched by tests/test_distributed.py as
``python _dist_worker.py <coordinator> <num_procs> <proc_id> <out.json>``.

Each process brings up the JAX multi-process runtime over the gloo CPU
collectives backend (2 local virtual devices -> 4 global devices),
builds a global time mesh spanning both processes, and runs the
time-sharded PCPS acquisition so the partial-power ``psum`` actually
crosses the process boundary — the multi-host pattern from SURVEY.md
section 5 ("distributed communication backend") exercised for real, not
emulated in one process.

It also walks the host-ingest path: ``partition_stream`` gives this
host its time shard (with halo), the shard is acquired locally with the
NCO anchored at the shard's global start sample, and the detected
events are written out keyed by *global* sample index for the parent to
merge with ``merge_shard_results``.
"""
import json
import sys

import numpy as np


def main() -> None:
    coordinator, n_procs, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    import jax

    # CPU-pinned (same pattern as tests/conftest.py) before the
    # distributed runtime initializes the backend: these worker
    # processes must never open a GPU, which one process per card owns.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from gnss_sdr import parallel

    assert parallel.initialize_from_env(
        coordinator_address=coordinator,
        num_processes=n_procs,
        process_id=pid,
    )
    assert jax.process_count() == n_procs, jax.process_count()
    assert jax.device_count() == 2 * n_procs, jax.device_count()

    import jax.numpy as jnp

    from gnss_sdr.models import GPS_L1CA, signal
    from gnss_sdr.ops import pcps

    fs = 2_046_000.0
    spec = GPS_L1CA
    n0 = spec.samples_per_code(fs)
    # 20 ms so each host's authoritative shard still integrates the full
    # reference-grade 10 ms (threshold 7 is calibrated for 10 ms,
    # do_acquisition.rs:237,23 — fewer ms false-alarms on peak/avg)
    n_int = 20
    n_time = 2 * n_procs

    scene = [
        signal.SatelliteScenario(prn=5, doppler_hz=1500.0,
                                 code_phase_chips=210.0).with_code_doppler(),
        signal.SatelliteScenario(prn=17, doppler_hz=-2500.0,
                                 code_phase_chips=700.5).with_code_doppler(),
    ]
    # deterministic: every process renders the identical full stream
    samples = signal.synthesize(
        scene, n_int * n0, fs, noise_std=4.0, seed=7
    )
    code_ffts = pcps.code_replica_ffts(spec, fs, 32)
    grid = jnp.asarray(pcps.doppler_grid(7_000.0, 500.0))

    # --- single-device reference (local arrays only) ------------------
    ref = pcps.pcps_search(
        jnp.asarray(samples), code_ffts, grid, fs_hz=fs, n_int=n_int
    )
    ref = jax.device_get(ref)

    # --- cross-process collective: time-sharded psum acquisition ------
    mesh = parallel.global_mesh(n_time=n_time)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.make_array_from_callback(
        samples.shape,
        NamedSharding(mesh, P(parallel.TIME_AXIS)),
        lambda idx: samples[idx],
    )
    out = parallel.time_sharded_pcps_search(
        mesh, sharded, code_ffts, grid, fs_hz=fs, n_int=n_int
    )
    out = jax.device_get(out)

    np.testing.assert_array_equal(out.detected, ref.detected)
    np.testing.assert_array_equal(out.code_phase_samples,
                                  ref.code_phase_samples)
    np.testing.assert_allclose(out.ratio, ref.ratio, rtol=2e-4)

    # --- host-ingest path: this host acquires only its time shard -----
    shards = parallel.partition_stream(
        n_int * n0, n_hosts=n_procs, halo=n0
    )
    me = shards[pid]
    local = signal.synthesize(
        scene, me.count, fs, noise_std=4.0, seed=7, start_sample=me.start
    )
    # noise continuity across the shard seam is irrelevant for the
    # detector; what must hold is the signal phase/code continuity that
    # start_sample guarantees.
    n_local_int = me.core_count // n0
    loc = pcps.pcps_search(
        jnp.asarray(local[: n_local_int * n0]), code_ffts, grid,
        fs_hz=fs, n_int=n_local_int,
    )
    loc = jax.device_get(loc)
    events = []
    for p in range(32):
        if bool(loc.detected[p]):
            events.append({
                "prn": p + 1,
                # global code-phase: shard-local lag + shard start,
                # folded to one code period (the absolute-sample time
                # base, multicast_ring_buffer.rs:103-105)
                "global_sample": int(
                    (int(loc.code_phase_samples[p]) + me.start) % n0
                    + me.core_start
                ),
                "code_phase": int(
                    (int(loc.code_phase_samples[p]) + me.start) % n0
                ),
                "carrier_freq_hz": float(loc.carrier_freq_hz[p]),
            })

    with open(out_path, "w") as f:
        json.dump({
            "process_id": pid,
            "process_count": jax.process_count(),
            "device_count": jax.device_count(),
            "timeshard_matches_reference": True,
            "ref_detected_prns": [
                p + 1 for p in range(32) if bool(ref.detected[p])
            ],
            "ref_code_phase": {
                str(p + 1): int(ref.code_phase_samples[p])
                for p in range(32) if bool(ref.detected[p])
            },
            "shard": {"start": me.start, "count": me.count,
                      "core_start": me.core_start,
                      "core_count": me.core_count, "halo": me.halo},
            "events": events,
        }, f)

    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
