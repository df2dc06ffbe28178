"""Benchmark: the receiver's main path on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "x_realtime", "device": {...},
   "detail": {...}}

value = real-time factor (seconds of signal per wall second) of
        32-channel GPS L1 C/A tracking plus steady-state acquisition at
        2.046 MHz: the span program (FusedTracker.submit_span, 16 blocks
        of 500 ms on a device-resident stream) plus one full 32 PRN x
        29 Doppler x 10 ms FFT search per 2 s of signal (the reference's
        steady pacing, do_acquisition.rs:62).
detail = the same on 500 ms cold pacing; the end-to-end Receiver in
        both span modes on the 24-satellite scene; time to first fix on
        the live-LNAV scene; the 32-channel four-constellation receiver
        at 8.184 MHz. Every run uses device-resident sources.

``device`` names the platform, device kind and count, and the card's
name and power limit as nvidia-smi reports them. A run that finds no
GPU fails, and any failing sub-run fails the whole run. Receiver rates
(``rtf``) are all signal over all wall time of two timed passes;
``pass_agreement`` is the slower pass's rate over the faster's.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np

GPS_FS = 2_046_000.0
MIXED_FS = 8_184_000.0


def device_info(jax) -> dict:
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    return info


def _passes_rate(signal_s, walls) -> dict:
    """Rate over all timed passes, and how far the passes agree."""
    rates = [signal_s / w for w in walls]
    return {"rtf": signal_s * len(walls) / sum(walls),
            "pass_agreement": min(rates) / max(rates)}


def _timed(fn, reps):
    """Mean wall time of ``fn()`` (which must block until done) over
    ``reps`` runs, and each run's time."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return sum(out) / reps, out


def headline(jax, sz):
    import jax.numpy as jnp

    from gnss_sdr.config import TrackConfig
    from gnss_sdr.models import GPS_L1CA, scenes
    from gnss_sdr.ops import pcps
    from gnss_sdr.receiver import fused_runner as fr
    from gnss_sdr.receiver import tracking as trk

    spec, n_ch = GPS_L1CA, 32
    n0 = spec.samples_per_code(GPS_FS)
    t_epochs, span = sz["block_ms"], sz["span"]
    cfg = TrackConfig(n_channels=n_ch, correlator="fused")
    params = trk.TrackParams.create(cfg, spec, GPS_FS)
    table = np.asarray(trk.make_sampled_code_table(spec, GPS_FS, 32,
                                                   window=params.window))
    rows = jnp.asarray(table[np.arange(n_ch) % 32])
    block = t_epochs * n0
    history = 4 * n0 + 8192
    # 32 channels on 24 satellites (the receiver's steady state), each
    # on its code boundary; stream staged on the device once
    sats = scenes.gps24()
    sig = scenes.render(sats, history + span * block, GPS_FS, seed=3)
    sre = jax.device_put(sig.real)
    sim = jax.device_put(sig.imag)
    st = trk.init_state(n_ch)
    for ch in range(n_ch):
        s = sats[ch % len(sats)]
        lag = int(round(-s.code_phase_chips / spec.code_rate_hz * GPS_FS))
        st = trk.start_channel(st, ch, s.prn - 1, s.doppler_hz,
                               n0 + lag % n0, spec.code_rate_hz)
    ft = fr.FusedTracker(params, cfg, spec, GPS_FS, table, t_epochs,
                         history + block)

    def track():
        h = ft.submit_span(st, sre, sim, rows, span)
        jax.block_until_ready((h.led, h.ys))

    n_int = 10
    acq_x = jax.device_put(scenes.render(sats, n_int * n0, GPS_FS, seed=9))
    ffts = pcps.code_replica_ffts(spec, GPS_FS, 32)
    grid = jnp.asarray(pcps.doppler_grid(14_000.0, 500.0))
    search = jax.jit(pcps.pcps_search, static_argnames=("fs_hz", "n_int"))

    def acquire():
        jax.block_until_ready(search(acq_x, ffts, grid, fs_hz=GPS_FS,
                                     n_int=n_int))

    track()
    acquire()                                    # compile outside timing
    t_track, track_runs = _timed(track, 3)
    t_acq, _ = _timed(acquire, 5)
    signal_s = span * t_epochs / 1000.0
    rtf = signal_s / (t_track + t_acq * signal_s / 2.0)
    rtf_cold = signal_s / (t_track + t_acq * signal_s / 0.5)
    return rtf, {
        "track_ms_per_signal_s": 1e3 * t_track / signal_s,
        "track_span_runs_s": track_runs,
        "acq_full_search_ms": 1e3 * t_acq,
        "rtf_cold_500ms_pacing": rtf_cold,
    }


def e2e(jax, sz):
    """Receiver.run(scan_blocks) on the 24-satellite scene, both span
    modes; two timed passes each after a warm-up that compiles every
    shape (the passes must agree)."""
    from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
    from gnss_sdr.models import scenes
    from gnss_sdr.receiver import DeviceArraySource, Receiver

    span, block_ms = sz["span"], sz["block_ms"]
    meas = 2 * span
    warm = 2 + 2 * span     # cold search, steady switch, two spans
    n_blocks = warm + 2 * meas + 1
    sig = scenes.render(scenes.gps24(),
                        int(n_blocks * block_ms / 1000 * GPS_FS), GPS_FS,
                        seed=3)
    out = {}
    for mode, pipeline in (("span", False), ("span_pipeline", True)):
        rx = Receiver(ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=GPS_FS),
            acq=AcqConfig(),
            track=TrackConfig(n_channels=32, correlator="fused"),
            block_ms=block_ms), DeviceArraySource(sig, GPS_FS, store="int8"))
        rx.run(max_blocks=warm, scan_blocks=span, span_pipeline=pipeline)
        sig_s = meas * block_ms / 1000.0
        walls, passes = [], []
        for _ in range(2):
            before = {k: v["total_s"] for k, v in rx.timers.report().items()}
            t0 = time.perf_counter()
            rx.run(max_blocks=meas, scan_blocks=span, span_pipeline=pipeline)
            walls.append(time.perf_counter() - t0)
            passes.append({
                "rtf": sig_s / walls[-1],
                "stage_ms_per_signal_s": {
                    k: 1e3 * (v["total_s"] - before.get(k, 0.0)) / sig_s
                    for k, v in rx.timers.report().items()}})
        tracked = rx.summary()["tracked_prns"]
        if tracked != list(range(1, 25)):
            raise AssertionError(f"{mode}: tracked {tracked}")
        out[mode] = {**_passes_rate(sig_s, walls), "passes": passes}
    return out


def ttff(jax, sz):
    """Cold start on the live-LNAV scene to the first position fix (wall
    time from receiver start; compiles warmed on a prefix)."""
    from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
    from gnss_sdr.models import scenes
    from gnss_sdr.receiver import DeviceArraySource, Receiver

    sats, ephs, total_s = scenes.live_lnav()
    sig = scenes.render(sats, int(total_s * GPS_FS), GPS_FS, seed=23)

    def make(arr):
        return Receiver(ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=GPS_FS),
            acq=AcqConfig(),
            track=TrackConfig(n_channels=8, carrier_aiding=True,
                              interp_code=True, correlator="fused"),
            block_ms=sz["ttff_block_ms"]),
            DeviceArraySource(arr, GPS_FS, store="int8"))

    make(sig[: int(7.0 * GPS_FS)]).run(scan_blocks=4)
    first = {}
    rx = make(sig)
    t0 = time.perf_counter()

    def check(r):
        if "wall" in first or len(r.nav.ephemerides) < 4:
            return False
        sol = r.nav.compute_pvt(0, r.f_if, r.spec.carrier_freq_hz)
        if sol is not None:
            first.update(wall=time.perf_counter() - t0,
                         signal_s=r.time_ms / 1000.0, sol=sol)
        return False                       # run the whole scene

    rx.run(scan_blocks=4, on_block=check)
    if "sol" not in first:
        raise AssertionError(f"no fix: {rx.summary()['nav']}")
    last = rx.compute_pvt()

    def err(sol):
        return float(np.linalg.norm(np.asarray(sol.position_ecef_m)
                                    - scenes.RX_TRUE))

    return {"ttff_wall_s": first["wall"], "ttff_signal_s": first["signal_s"],
            "first_fix_err_m": err(first["sol"]),
            "first_fix_gdop": float(first["sol"].gdop),
            "converged_fix_err_m": None if last is None else err(last),
            "ephemerides": sorted(rx.nav.ephemerides)}


def mixed(jax, sz):
    """32 channels over four constellations, one 8.184 MHz stream."""
    from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
    from gnss_sdr.models import scenes
    from gnss_sdr.receiver import DeviceArraySource, MultiConstellationReceiver

    block_ms, span = 100, sz["mixed_span"]
    warm, meas = 2 * span, 2 * span
    n_blocks = warm + span + 2 * meas + 3
    sig = scenes.render(scenes.mixed32(),
                        int(n_blocks * block_ms / 1000 * MIXED_FS),
                        MIXED_FS, seed=7)
    rf = RfConfig(freq_if_hz=0.0, output_sample_rate_hz=MIXED_FS)

    def cfg(signal, n_ch, **acq):
        return ReceiverConfig(
            rf=rf, acq=AcqConfig(signal=signal, **acq),
            track=TrackConfig(signal=signal, n_channels=n_ch,
                              correlator="fused"), block_ms=block_ms)

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
    mrx = MultiConstellationReceiver(configs, sources={
        n: DeviceArraySource(sig, MIXED_FS, store="int8") for n in configs})
    mrx.run(max_blocks=warm)
    mrx.run(max_blocks=span, scan_blocks=span)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        mrx.run(max_blocks=meas, scan_blocks=span)
        walls.append(time.perf_counter() - t0)
    return {**_passes_rate(meas * block_ms / 1000.0, walls),
            "pass_walls_s": walls,
            "tracked": {k: v["tracked_prns"]
                        for k, v in mrx.summary().items()}}


SIZES = dict(block_ms=500, span=16, ttff_block_ms=500, mixed_span=10)


def main():
    import jax

    from gnss_sdr.utils.host import tune_host_allocator
    from gnss_sdr.utils.platform import enable_compile_cache

    dev = device_info(jax)
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev['platform']}")
    tune_host_allocator()
    enable_compile_cache()
    rtf, detail = headline(jax, SIZES)
    for name, fn in (("e2e", e2e), ("ttff", ttff), ("mixed", mixed)):
        detail[name] = fn(jax, SIZES)
    print(json.dumps({
        "metric": ("real-time factor, 32-ch GPS L1 C/A tracking + paced "
                   "acquisition @ 2.046 MHz, 1 device"),
        "value": rtf, "unit": "x_realtime", "device": dev,
        "detail": detail}))


if __name__ == "__main__":
    main()
