"""Device-mesh sharding of acquisition and tracking.

The reference's entire parallelism inventory is OS threads + rayon pools
inside one process (SURVEY.md section 2 table). The design here
scales the same axes across a device mesh instead:

  * **channel axis** — tracking channels (and acquisition PRN rows) are
    batch dimensions; sharding them over devices is pure data
    parallelism with no cross-device communication in the steady state
    (each channel's loop state lives on the shard that owns it).
  * **time axis** — acquisition's non-coherent integrations are
    independent 1 ms correlations; time shards each integrate a slice of
    the capture and ``psum`` their partial power cubes over NVLink
    (NCCL) — the collective-maxima/overlap pattern from BASELINE.md.
    Exactness is
    preserved because the uint32 NCO lets any shard start its Doppler
    phase ramp at an arbitrary global sample offset.

Tracking is *sequential* in time per channel (loop filters carry), so
time sharding applies to acquisition and front-end conditioning, not to
a single channel's tracking loop — the parallel axes for tracking are
channels and constellations.

All entry points also run on a 1-device mesh, and on the CPU backend
with ``--xla_force_host_platform_device_count=N`` for testing.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import pcps
from ..receiver import tracking as trk

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_mesh(n_time: int = 1, n_channel: int | None = None,
              devices=None) -> Mesh:
    """Build a (time, channel) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_channel is None:
        n_channel = len(devices) // n_time
    n = n_time * n_channel
    if n > len(devices):
        raise ValueError(
            f"mesh {n_time}x{n_channel} needs {n} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[:n]).reshape(n_time, n_channel)
    return Mesh(grid, axis_names=(TIME_AXIS, CHANNEL_AXIS))


# ---------------------------------------------------------------------------
# channel-sharded tracking
# ---------------------------------------------------------------------------

def shard_channel_state(mesh: Mesh, state: trk.ChannelState) -> trk.ChannelState:
    """Place every [C] state leaf with the channel axis sharded."""
    sh = NamedSharding(mesh, P(CHANNEL_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def shard_fused_step(mesh: Mesh, step_fn):
    """A FusedTracker block step under ``shard_map``: channels sharded
    over the mesh's channel axis, the sample stream replicated.

    Each device runs the block step on its own channel rows — zero
    steady-state collectives, the fused analogue of
    ``sharded_track_block`` (reference scales the same axis with a
    rayon pool, do_tracking.rs:364-371).

    Returns a callable with the step's signature
    ``(stream_re, stream_im, codes_rows, state, base)``.
    """
    chn = P(CHANNEL_AXIS)
    rep = P()
    # check_vma=False: pallas_call outputs carry no varying-axis
    # annotation, so the static checker cannot see that every output is
    # channel-shard-local. The invariant is ASSERTED instead:
    # tests/test_parallel.py::TestFusedOnMesh proves 4-device output
    # bit-identical to 1-device for both run_block and run_blocks.
    return jax.shard_map(
        step_fn, mesh=mesh,
        in_specs=(rep, rep, P(CHANNEL_AXIS, None), chn, rep),
        out_specs=(chn, P(None, CHANNEL_AXIS)),   # state [C], telem [T, C]
        check_vma=False)


def sharded_track_block(
    mesh: Mesh,
    params: trk.TrackParams,
    codes: jax.Array,          # [C, L*os]
    state: trk.ChannelState,   # [C] leaves (channel-sharded or not)
    block_re: jax.Array,
    block_im: jax.Array,
    n_epochs: int,
    valid_len=None,
):
    """track_block under GSPMD with channels sharded, blocks replicated.

    Channel count must be divisible by the mesh's channel axis size.
    The scan-over-epochs and per-channel loop state stay entirely local
    to each shard — zero collectives in steady-state tracking.
    """
    ch_sh = NamedSharding(mesh, P(CHANNEL_AXIS))
    rep = NamedSharding(mesh, P())
    state = jax.tree.map(lambda x: jax.device_put(x, ch_sh), state)
    codes = jax.device_put(codes, NamedSharding(mesh, P(CHANNEL_AXIS, None)))
    block_re = jax.device_put(block_re, rep)
    block_im = jax.device_put(block_im, rep)
    return trk.track_block(
        params, codes, state, block_re, block_im, n_epochs, valid_len
    )


# ---------------------------------------------------------------------------
# PRN-sharded acquisition (channel axis)
# ---------------------------------------------------------------------------

def sharded_pcps_search(
    mesh: Mesh,
    samples: jax.Array,
    code_ffts: jax.Array,
    carrier_freqs: jax.Array,
    *,
    fs_hz: float,
    n_int: int,
    threshold: float = 7.0,
):
    """PCPS with the PRN batch sharded over the channel axis.

    The [P, D, N] power cube and the per-PRN detector stay sharded on P;
    results gather implicitly on read-out. No inter-shard communication
    beyond the final gather.
    """
    prn_sh = NamedSharding(mesh, P(CHANNEL_AXIS, None))
    rep = NamedSharding(mesh, P())
    samples = jax.device_put(samples, rep)
    code_ffts = jax.device_put(code_ffts, prn_sh)
    carrier_freqs = jax.device_put(carrier_freqs, rep)
    return pcps.pcps_search(
        samples, code_ffts, carrier_freqs,
        fs_hz=fs_hz, n_int=n_int, threshold=threshold,
    )


# ---------------------------------------------------------------------------
# time-sharded acquisition (time axis): psum of partial power cubes
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("mesh", "fs_hz", "n_int", "threshold"),
)
def time_sharded_pcps_search(
    mesh: Mesh,
    samples: jax.Array,        # [n_int * N] complex64, n_int % n_time == 0
    code_ffts: jax.Array,      # [P, N]
    carrier_freqs: jax.Array,  # [D]
    *,
    fs_hz: float,
    n_int: int,
    threshold: float = 7.0,
):
    """Each time shard integrates n_int/n_time milliseconds and the
    partial non-coherent power cubes reduce with ``psum`` over NVLink
    (NCCL).

    The Doppler mix phase of shard t starts at global sample
    t * (n_int/n_time) * N via the NCO's ``sample_offset``, so the
    result is exactly the single-device computation (up to f32 sum
    order)."""
    n_time = mesh.shape[TIME_AXIS]
    if n_int % n_time:
        raise ValueError(f"n_int={n_int} not divisible by time axis {n_time}")
    n_local = n_int // n_time
    n_fft = code_ffts.shape[-1]

    def local(chunk, codes, freqs):
        t = jax.lax.axis_index(TIME_AXIS)
        power = pcps.pcps_power(
            chunk.reshape(-1), codes, freqs,
            fs_hz=fs_hz, n_int=n_local,
            sample_offset=t * (n_local * n_fft),
        )
        return jax.lax.psum(power, TIME_AXIS)

    # check_vma=False: pcps_power's scan carry starts replicated while the
    # scanned spectra are shard-varying; the psum at the end restores
    # replication, which the static varying-axis checker cannot see. The
    # invariant is ASSERTED instead (same policy as shard_fused_step):
    # tests/test_parallel.py::TestShardedAcquisition::
    # test_time_sharded_matches proves 2/4/8-device output equal to the
    # single-device reference (detected/code-phase exact, ratio to fp
    # sum-order tolerance).
    power = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(TIME_AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(samples, code_ffts, carrier_freqs)
    return pcps.detect(power, carrier_freqs, threshold)
