"""Multi-host runtime glue (jax.distributed).

The reference is single-process (SURVEY.md section 4: "no multi-node
story"). This module carries the multi-host story: process-group
initialization, global meshes spanning hosts, and the host-level
partitioning of a sample stream — each host ingests its own time slice
with halo overlap so acquisition chunks and tracking windows near shard
boundaries stay complete (the overlap-save pattern; partial power cubes
then combine with psum over the network or NVLink (NCCL) via
parallel.sharding.time_sharded_pcps_search).

Single-host sessions work unchanged: every helper degrades to the
1-host case, which is how the test suite exercises the partition math.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX multi-process runtime.

    Arguments default to the standard environment variables
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID;
    without them the process runs alone). Returns True when a
    multi-process runtime was initialized, False for single-process.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(n_time: int = 1, n_channel: Optional[int] = None):
    """(time, channel) mesh over ALL devices of all hosts (the global
    device list under jax.distributed); validation and layout shared
    with sharding.make_mesh."""
    import jax

    from .sharding import make_mesh

    return make_mesh(n_time=n_time, n_channel=n_channel,
                     devices=jax.devices())


@dataclasses.dataclass(frozen=True)
class TimeShard:
    """One host's slice of the global sample stream."""

    host_id: int
    start: int          # global sample index this host ingests from
    count: int          # samples it ingests (including the halo)
    halo: int           # trailing overlap shared with the next host
    core_start: int     # first sample this host is authoritative for
    core_count: int     # samples it is authoritative for


def partition_stream(
    total_samples: int,
    n_hosts: int,
    halo: int,
) -> list[TimeShard]:
    """Split a stream into per-host time shards with trailing halos.

    Host h owns samples [h*B, (h+1)*B) (B = total/n_hosts) and also
    ingests ``halo`` samples beyond its end so windows/acquisition
    chunks crossing the boundary stay local — the overlap-save
    equivalent of the reference's shared multicast ring.
    """
    if total_samples % n_hosts:
        raise ValueError(
            f"total_samples={total_samples} not divisible by {n_hosts}"
        )
    block = total_samples // n_hosts
    if halo >= block:
        raise ValueError(f"halo={halo} must be < per-host block {block}")
    shards = []
    for h in range(n_hosts):
        start = h * block
        extra = halo if h < n_hosts - 1 else 0
        shards.append(TimeShard(
            host_id=h, start=start, count=block + extra, halo=extra,
            core_start=start, core_count=block,
        ))
    return shards


def merge_shard_results(shards: list[TimeShard],
                        per_shard_events: list[list[dict]]) -> list[dict]:
    """Merge per-host event lists (e.g. acquisition candidates keyed by
    'global_sample'), keeping each event only from its authoritative
    shard so halo regions never double-report."""
    out = []
    for shard, events in zip(shards, per_shard_events):
        lo = shard.core_start
        hi = shard.core_start + shard.core_count
        for ev in events:
            g = ev.get("global_sample", lo)
            if lo <= g < hi:
                out.append(ev)
    return sorted(out, key=lambda e: e.get("global_sample", 0))
