"""Real 2-process jax.distributed test (VERDICT round-1 item 5).

Spawns two fresh Python processes that each call
``parallel.initialize_from_env`` against a shared coordinator, form a
4-device global mesh (2 virtual CPU devices per process, gloo
collectives), and run ``time_sharded_pcps_search`` so the non-coherent
power ``psum`` crosses the process boundary. The parent then merges the
per-host shard events with ``merge_shard_results`` and checks them
against the single-device reference each worker recorded.

This is the multi-host story the reference never had (SURVEY.md
section 4: "No distributed tests and no multi-node story exist").
"""
import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_time_sharded_acquisition(tmp_path):
    port = _free_port()
    coordinator = f"localhost:{port}"
    outs = [tmp_path / f"proc{i}.json" for i in range(2)]

    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers pin platform/device-count via jax.config themselves
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(i), str(outs[i])],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out\n" + "\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    results = [json.loads(o.read_text()) for o in outs]

    # both processes saw the full 2-process / 4-device global runtime
    for r in results:
        assert r["process_count"] == 2
        assert r["device_count"] == 4
        assert r["timeshard_matches_reference"] is True
        assert sorted(r["ref_detected_prns"]) == [5, 17]

    # single-device reference agrees across processes (determinism)
    assert results[0]["ref_code_phase"] == results[1]["ref_code_phase"]

    # merge the per-host shard events exactly as a multi-host deployment
    # would: halo regions must not double-report
    from gnss_sdr import parallel

    shards = [
        parallel.TimeShard(host_id=i, **{
            "start": r["shard"]["start"],
            "count": r["shard"]["count"],
            "halo": r["shard"]["halo"],
            "core_start": r["shard"]["core_start"],
            "core_count": r["shard"]["core_count"],
        })
        for i, r in enumerate(results)
    ]
    merged = parallel.merge_shard_results(
        shards, [r["events"] for r in results]
    )
    ref_phase = results[0]["ref_code_phase"]
    # every shard detects both satellites; the merge keeps each PRN once
    # per authoritative region, and the *global* code phase recovered
    # from any shard equals the single-device reference lag
    assert {e["prn"] for e in merged} == {5, 17}
    for ev in merged:
        assert ev["code_phase"] == ref_phase[str(ev["prn"])], ev
