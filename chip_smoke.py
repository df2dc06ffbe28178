"""On-card smoke run: the receiver's main path on one NVIDIA GPU, through
its normal entry points, at the widths users run.

    python chip_smoke.py              phases 1-5, one card
    python chip_smoke.py --devices 4  phase 6 only: the channel-sharded
                                      receiver and the time-sharded
                                      search on four cards vs one card

Phases (each prints one line; any failure raises, nothing is caught):
  1. device: a GPU, its kind and count, name and power limit;
  2. kernel parity: the compiled block tracking step against the XLA
     reference ``track_block`` on seeded scenes (rules and tolerances:
     gnss_sdr/utils/parity.py);
  3. acquisition: FFT PCPS (32 PRN x 29 Doppler x 10 ms at 2.046 MHz) on
     the card against the same function on the CPU device;
  4. receiver: ``Receiver.run(scan_blocks=16)`` in both span modes on the
     24-satellite 32-channel scene, and ``python -m gnss_sdr --config
     ... --pvt --json`` (run in this process) on an int8 real-IF capture
     at 16.3676 MHz carrying live LNAV frames, to a position fix;
  5. multi-constellation: the 32-channel four-system receiver at
     8.184 MHz, whose tracked sets must equal those of the same receiver
     on the XLA reference correlator (``slice``, one block at a time),
     run on the CPU in a child process that never touches the card.

The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Scratch files go to ``.smoke/`` in the checkout (listed in .gitignore)
and are removed at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SCRATCH = ROOT / ".smoke"
GPS_FS = 2_046_000.0
MIXED_FS = 8_184_000.0
CAPTURE_FS = 16_367_600.0
CAPTURE_IF = 4_130_400.0
CAPTURE_DECIM = 4
# sizes the card runs: (signal, sample rate, channels, epochs) per
# parity case; GPS at 8.184 MHz is the mixed receiver's GPS branch
PARITY_CASES = (("gps_l1ca", GPS_FS, 32, 500),
                ("gps_l1ca", MIXED_FS, 32, 500),
                ("galileo_e1b", MIXED_FS, 4, 125),
                ("beidou_b1i", MIXED_FS, 4, 250),
                ("glonass_l1of", MIXED_FS, 4, 250))
RX_CHANNELS, RX_BLOCK_MS, RX_SPAN = 32, 500, 16
MIXED_BLOCKS, MIXED_BLOCK_MS, MIXED_SPAN = 30, 100, 10
# acquisition parity: detection ratios agree to this relative tolerance
# (FFT and reduction order differ between the two backends); detected
# set, code phase and Doppler bin agree exactly
ACQ_RATIO_RTOL = 1e-3
# live-LNAV CLI fix: position error bound [m] (the float64 oracle's
# constant-rate scene plus code tracking noise at 4 samples/chip)
FIX_ERR_M = 100.0


def say(phase, **kw):
    print(f"phase {phase}: " + json.dumps(kw, default=str), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


# -- phase 2 ----------------------------------------------------------------

def kernel_parity():
    import jax.numpy as jnp
    import numpy as np

    from gnss_sdr.config import TrackConfig
    from gnss_sdr.models import SatelliteScenario, get_signal, scenes
    from gnss_sdr.receiver import fused_runner as fr
    from gnss_sdr.receiver import tracking as trk
    from gnss_sdr.utils import parity

    for name, fs, n_ch, t in PARITY_CASES:
        spec = get_signal(name)
        n0 = spec.samples_per_code(fs)
        params = trk.TrackParams.create(
            TrackConfig(n_channels=n_ch, correlator="fused"), spec, fs)
        prns = list(range(1, n_ch + 1))
        # GLONASS shares one code; FDMA channels k = -2..1 separate it
        dops = [(562_500.0 * (ch - 2) if spec.name == "glonass_l1of"
                 else 0.0) + 150.0 * ch - 900.0 for ch in range(n_ch)]
        sats = [SatelliteScenario(prn=p if spec.name != "glonass_l1of"
                                  else 1, doppler_hz=d, amplitude=0.3,
                                  signal=spec) for p, d in zip(prns, dops)]
        buf = (t + 2) * n0
        sig = scenes.render(sats, buf, fs, noise_std=1.0, seed=5)
        sre = jnp.asarray(sig.real)
        sim = jnp.asarray(sig.imag)
        table = np.asarray(trk.make_sampled_code_table(
            spec, fs, max(prns) if spec.name != "glonass_l1of" else 1,
            window=params.window))
        rows = jnp.asarray(table[[(p - 1) % table.shape[0] for p in prns]])
        st = trk.init_state(n_ch)
        for ch in range(n_ch):        # each channel on its code boundary
            st = trk.start_channel(st, ch, prns[ch] - 1, dops[ch], n0,
                                   spec.code_rate_hz)
        ref = trk.track_block(params, rows, st, sre, sim, t)
        got = fr.block_step(sre, sim, rows, st, 0, params=params,
                            t_epochs=t, buf_len=buf)
        bad = parity.track_mismatches(ref, got, spec.code_length_chips)
        errs = parity.max_errors(ref, got, spec.code_length_chips)
        locked = float(np.asarray(ref[1].locked).mean())
        if bad:
            raise AssertionError(f"{name}: step vs reference {bad}")
        say(2, signal=name, fs_hz=fs, channels=n_ch, epochs=t,
            locked_fraction=round(locked, 3), max_abs_err=errs)


# -- phase 3 ----------------------------------------------------------------

def acquisition_parity():
    import jax
    import numpy as np

    from gnss_sdr.models import GPS_L1CA, scenes
    from gnss_sdr.ops import pcps

    n_int = 10
    n0 = GPS_L1CA.samples_per_code(GPS_FS)
    x = scenes.render(scenes.gps24(), n_int * n0, GPS_FS, seed=9)
    grid = pcps.doppler_grid(14_000.0, 500.0)
    assert grid.shape == (29,)
    ffts = np.asarray(pcps.code_replica_ffts(GPS_L1CA, GPS_FS, 32))
    search = jax.jit(pcps.pcps_search, static_argnames=("fs_hz", "n_int"))
    g, c = (jax.device_get(search(
        *(jax.device_put(a, dev) for a in (x, ffts, grid)),
        fs_hz=GPS_FS, n_int=n_int))
        for dev in (jax.devices()[0], jax.devices("cpu")[0]))
    det = np.asarray(g.detected)
    if not np.array_equal(det, np.asarray(c.detected)):
        raise AssertionError("detected sets differ")
    for f in ("code_phase_samples", "carrier_freq_hz"):
        if not np.array_equal(np.asarray(getattr(g, f))[det],
                              np.asarray(getattr(c, f))[det]):
            raise AssertionError(f"{f} differs on detected PRNs")
    rel = float(np.max(np.abs(g.ratio - c.ratio) / np.abs(c.ratio)))
    if rel > ACQ_RATIO_RTOL:
        raise AssertionError(f"ratio differs by {rel:.2e}")
    found = sorted(int(p) + 1 for p in np.flatnonzero(det))
    if found != list(range(1, 25)):
        raise AssertionError(f"detected {found}, truth PRNs 1-24")
    say(3, detected=len(found), ratio_max_rel_err=rel)


# -- phase 4 ----------------------------------------------------------------

def gps24_receiver(mesh_channels: int = 1, span_pipeline: bool = False,
                   sig=None):
    from gnss_sdr.config import (AcqConfig, ParallelConfig, ReceiverConfig,
                                 RfConfig, TrackConfig)
    from gnss_sdr.receiver import DeviceArraySource, Receiver

    rx = Receiver(ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=GPS_FS),
        acq=AcqConfig(),
        track=TrackConfig(n_channels=RX_CHANNELS, correlator="fused"),
        parallel=ParallelConfig(channel_axis=mesh_channels),
        block_ms=RX_BLOCK_MS), DeviceArraySource(sig, GPS_FS, store="int8"))
    t0 = time.perf_counter()
    # two single blocks (cold search, then the switch to steady mode),
    # then two spans
    s = rx.run(max_blocks=2 + 2 * RX_SPAN, scan_blocks=RX_SPAN,
               span_pipeline=span_pipeline)
    return rx, s, time.perf_counter() - t0


def gps24_signal():
    from gnss_sdr.models import scenes

    n_blocks = 3 + 2 * RX_SPAN
    return scenes.render(scenes.gps24(),
                         int(n_blocks * RX_BLOCK_MS / 1000 * GPS_FS), GPS_FS,
                         seed=3)


def receiver_spans(sig):
    for pipeline in (False, True):
        rx, s, wall = gps24_receiver(span_pipeline=pipeline, sig=sig)
        calls = s["stage_timing"]["track"]["calls"]
        if s["tracked_prns"] != list(range(1, 25)):
            raise AssertionError(f"tracked {s['tracked_prns']}")
        if calls != 4:
            raise AssertionError(f"{calls} track calls, want 2 blocks + "
                                 "2 spans")
        say(4, mode="span_pipeline" if pipeline else "span",
            blocks=s["blocks"], track_calls=calls, tracked=24,
            wall_s_with_compile=round(wall, 2))


CLI_TOML = """block_ms = 100
[sdr]
driver = "file"
center_freq_hz = {center}
sample_rate_hz = {fs}
path = "{path}"
file_format = "int8_real"
[rf]
output_sample_rate_hz = {fs_out}
enable_dc_removal = true
enable_mixing = true
decimation = {decim}
[acq]
signal = "gps_l1ca"
[track]
signal = "gps_l1ca"
n_channels = 8
correlator = "fused"
carrier_aiding = true
interp_code = true
[pvt]
enable = true
"""


def cli_fix():
    import numpy as np

    from gnss_sdr import cli, constants
    from gnss_sdr.models import scenes

    sats, ephs, total_s = scenes.live_lnav()
    cap = SCRATCH / "live_capture.bin"
    scenes.write_real_if_int8(cap, sats, int(total_s * CAPTURE_FS),
                              CAPTURE_FS, CAPTURE_IF, seed=23)
    toml = SCRATCH / "live.toml"
    toml.write_text(CLI_TOML.format(
        center=constants.GPS_L1_FREQ_HZ + CAPTURE_IF, fs=CAPTURE_FS,
        fs_out=CAPTURE_FS / CAPTURE_DECIM, decim=CAPTURE_DECIM, path=cap))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", str(toml), "--pvt", "--json"])
    wall = time.perf_counter() - t0
    cap.unlink()
    if rc != 0:
        raise AssertionError(f"cli exit {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    if out["pvt"] is None:
        raise AssertionError(f"no fix: {out['nav']}")
    err = float(np.linalg.norm(np.asarray(out["pvt"]["ecef_m"])
                               - scenes.RX_TRUE))
    if sorted(out["tracked_prns"]) != sorted(ephs):
        raise AssertionError(f"tracked {out['tracked_prns']}")
    if err > FIX_ERR_M:
        raise AssertionError(f"fix error {err:.1f} m > {FIX_ERR_M} m")
    say(4, cli="python -m gnss_sdr --pvt --json", capture_fs_hz=CAPTURE_FS,
        signal_s=round(total_s, 1), ephemerides=out["ephemerides"],
        fix_err_m=round(err, 1), gdop=out["pvt"]["gdop"],
        wall_s_with_compile=round(wall, 1))


# -- phase 5 ----------------------------------------------------------------

def mixed_tracked(sig, correlator: str = "fused") -> dict:
    from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
    from gnss_sdr.receiver import ArraySource, MultiConstellationReceiver

    rf = RfConfig(freq_if_hz=0.0, output_sample_rate_hz=MIXED_FS)

    def cfg(signal, n_ch, **acq):
        return ReceiverConfig(
            rf=rf, acq=AcqConfig(signal=signal, **acq),
            track=TrackConfig(signal=signal, n_channels=n_ch,
                              correlator=correlator),
            block_ms=MIXED_BLOCK_MS)

    configs = {
        "gps_l1ca": cfg("gps_l1ca", 8),
        "galileo_e1b": cfg("galileo_e1b", 4, n_prn=36, non_coherent_ms=16,
                           detection_threshold=12.0),
        "glonass_l1of": cfg("glonass_l1of", 4, n_prn=14,
                            fdma_spacing_hz=562_500.0,
                            fdma_channels=tuple(range(-7, 7))),
        "beidou_b1i": cfg("beidou_b1i", 16, n_prn=37,
                          detection_threshold=10.0),
    }
    mrx = MultiConstellationReceiver(configs, ArraySource(sig, MIXED_FS))
    summary = mrx.run(max_blocks=MIXED_BLOCKS, scan_blocks=MIXED_SPAN)
    return {k: v["tracked_prns"] for k, v in summary.items()}


def multi_constellation():
    import numpy as np

    from gnss_sdr.models import scenes

    sig = scenes.render(scenes.mixed32(),
                        int((MIXED_BLOCKS + 1) * MIXED_BLOCK_MS / 1000
                            * MIXED_FS), MIXED_FS,
                        seed=7)
    npy = SCRATCH / "mixed.npy"
    np.save(npy, sig)
    t0 = time.perf_counter()
    gpu = mixed_tracked(sig)
    wall = time.perf_counter() - t0
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-mixed",
         str(npy), json.dumps([MIXED_BLOCKS, MIXED_BLOCK_MS, MIXED_SPAN])],
        env=env, capture_output=True, text=True, timeout=900,
        check=True)
    npy.unlink()
    cpu = json.loads(child.stdout.strip().splitlines()[-1])
    if gpu != cpu:
        raise AssertionError(f"tracked sets differ: gpu {gpu} cpu {cpu}")
    if sum(len(v) for v in gpu.values()) < 12:
        raise AssertionError(f"too few tracked: {gpu}")
    say(5, fs_hz=MIXED_FS, channels=32,
        signal_s=MIXED_BLOCKS * MIXED_BLOCK_MS / 1000,
        tracked=gpu, equals_cpu_slice_reference=True,
        wall_s_with_compile=round(wall, 1))


# -- phase 6 ----------------------------------------------------------------

def four_cards():
    import jax
    import numpy as np

    from gnss_sdr import parallel
    from gnss_sdr.models import GPS_L1CA, scenes
    from gnss_sdr.ops import pcps

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--devices 4 needs 4 cards, have {len(devs)}")
    sig = gps24_signal()
    rx1, s1, w1 = gps24_receiver(sig=sig)
    rx4, s4, w4 = gps24_receiver(mesh_channels=4, sig=sig)
    for s in (s1, s4):
        if s["tracked_prns"] != list(range(1, 25)):
            raise AssertionError(f"tracked {s['tracked_prns']}")
    ch1 = {c["prn"]: c for c in s1["channels"]}
    ch4 = {c["prn"]: c for c in s4["channels"]}
    if {p: c["epochs"] for p, c in ch1.items()} != {
            p: c["epochs"] for p, c in ch4.items()}:
        raise AssertionError("epoch counts differ between 1 and 4 cards")
    dop = max(abs(ch1[p]["last_doppler_hz"] - ch4[p]["last_doppler_hz"])
              for p in ch1)
    # each card holds its own quarter of the channels: ledger and
    # telemetry of one block step on the 4-card receiver
    ft = rx4.fused
    led, telem = jax.jit(ft._step)(
        rx4.window.re, rx4.window.im, rx4._codes_for_state(),
        ft._as_ledger(rx4.state), 0)
    per = RX_CHANNELS // 4
    placed = sorted((s.device.id, s.data.shape[-1])
                    for s in telem.i_p.addressable_shards)
    if (len({d for d, _ in placed}) != 4 or any(n != per for _, n in placed)
            or {s.data.shape[0] for s in led.offset.addressable_shards}
            != {per}):
        raise AssertionError(f"shards {placed}")
    say(6, receiver="channel_axis=4", tracked=24, epochs_equal=True,
        max_doppler_diff_hz=dop, channels_per_card=placed,
        wall_s_1card=round(w1, 2), wall_s_4cards=round(w4, 2))

    n0 = GPS_L1CA.samples_per_code(GPS_FS)
    n_int = 8
    x = scenes.render(scenes.gps24(), n_int * n0, GPS_FS, seed=9)
    ffts = pcps.code_replica_ffts(GPS_L1CA, GPS_FS, 32)
    grid = jax.numpy.asarray(pcps.doppler_grid(14_000.0, 500.0))
    one = jax.device_get(pcps.pcps_search(
        jax.numpy.asarray(x), ffts, grid, fs_hz=GPS_FS, n_int=n_int))
    tmesh = parallel.make_mesh(n_time=4, n_channel=1, devices=devs[:4])
    xs = jax.device_put(x, jax.sharding.NamedSharding(
        tmesh, jax.sharding.PartitionSpec(parallel.TIME_AXIS)))
    held = sorted(s.device.id for s in xs.addressable_shards)
    four = jax.device_get(parallel.time_sharded_pcps_search(
        tmesh, xs, ffts, grid, fs_hz=GPS_FS, n_int=n_int))
    det = np.asarray(one.detected)
    if not (np.array_equal(det, four.detected) and np.array_equal(
            one.code_phase_samples[det], four.code_phase_samples[det])
            and np.array_equal(one.carrier_freq_hz[det],
                               four.carrier_freq_hz[det])):
        raise AssertionError("time-sharded search differs from one card")
    rel = float(np.max(np.abs(one.ratio - four.ratio) / one.ratio))
    if rel > ACQ_RATIO_RTOL:
        raise AssertionError(f"ratio differs by {rel:.2e}")
    say(6, search="time_sharded_pcps_search n_time=4", stream_shards_on=held,
        detected=int(det.sum()), ratio_max_rel_err=rel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--cpu-mixed", nargs=2, metavar=("NPY", "SIZES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import jax

    import gnss_sdr  # noqa: F401  (fails outside a checkout)

    if args.cpu_mixed:                      # phase 5's reference
        import numpy as np

        global MIXED_BLOCKS, MIXED_BLOCK_MS, MIXED_SPAN
        npy, sizes = args.cpu_mixed
        MIXED_BLOCKS, MIXED_BLOCK_MS, MIXED_SPAN = json.loads(sizes)
        print(json.dumps(mixed_tracked(np.load(npy), correlator="slice")))
        return 0

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    say(1, platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()))
    print(smi(), flush=True)
    SCRATCH.mkdir(exist_ok=True)
    try:
        if args.devices == 4:
            four_cards()
        else:
            kernel_parity()
            acquisition_parity()
            receiver_spans(gps24_signal())
            cli_fix()
            multi_constellation()
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
