"""Command-line receiver application.

Capability parity with the reference's binary entry point
(reference: src/main.rs:167-230: load TOML -> open device -> wire the
pipeline -> run), as ``python -m gnss_sdr``. Sources resolve from
``[sdr] driver``: file (native ingest when built), synthetic test
scene, or mock device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_source(cfg):
    from .models.constellation import get_signal
    from .receiver import FileSource, SyntheticSource

    sdr = cfg.sdr
    if sdr.driver == "file":
        if not sdr.path:
            raise SystemExit("config error: [sdr] path required for file driver")
        try:
            from .io import NativeFileSource, native_available

            if native_available() and sdr.file_format in (
                "int8_real", "int8_iq"
            ):
                return NativeFileSource(
                    sdr.path, sdr.sample_rate_hz, sdr.file_format
                )
        except Exception:
            pass
        return FileSource(sdr.path, sdr.sample_rate_hz, sdr.file_format)
    if sdr.driver == "synthetic":
        from .models import SatelliteScenario

        spec = get_signal(cfg.acq.signal)
        sats = [
            SatelliteScenario(prn=p, doppler_hz=d, amplitude=0.25,
                              code_phase_chips=37.0 * p, signal=spec)
            for p, d in ((3, 1500.0), (9, -3200.0), (17, 5400.0))
        ]
        return SyntheticSource(
            sats, sdr.sample_rate_hz, f_if_hz=cfg.f_if_hz, noise_std=1.0,
            total_samples=int(2.0 * sdr.sample_rate_hz),
        )
    if sdr.driver == "mock":
        from .io import open_device

        dev = open_device("mock")
        dev.set_sample_rate(sdr.sample_rate_hz)
        dev.activate_stream()
        return dev
    # live SDR drivers via SoapySDR
    from .io import open_device

    dev = open_device(sdr.driver)
    dev.configure(json.dumps({
        "center_freq_hz": sdr.center_freq_hz,
        "sample_rate_hz": sdr.sample_rate_hz,
        "bandwidth_hz": sdr.bandwidth_hz,
        "gain_db": sdr.gain_db,
        "enable_agc": sdr.enable_agc,
    }))
    dev.activate_stream()
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnss_sdr",
        description="GNSS software receiver (JAX; CPU or GPU)",
    )
    ap.add_argument("--config", "-c", help="TOML receiver config")
    ap.add_argument("--blocks", type=int, default=None,
                    help="max blocks to process (default: to end of stream)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--dashboard", metavar="PNG",
                    help="render the receiver dashboard on exit")
    ap.add_argument("--pvt", action="store_true",
                    help="attempt a PVT solution on exit")
    ap.add_argument("--rinex-obs", metavar="PATH",
                    help="stream observables to a RINEX 3 OBS file")
    ap.add_argument("--obs-every-ms", type=int, default=1000)
    ap.add_argument("--gps-week", type=int, default=0,
                    help="GPS week number for RINEX timestamps")
    ap.add_argument("--ekf", action="store_true",
                    help="run the EKF navigation filter on observables")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON")
    ap.add_argument("--live", action="store_true",
                    help="live terminal status table while running "
                         "(the reference's NavigationView, view.rs:37)")
    ap.add_argument("--live-png", metavar="PNG",
                    help="re-render the dashboard PNG live (atomic "
                         "replace; watch it with any image viewer)")
    ap.add_argument("--live-fps", type=float, default=6.0,
                    help="max live refresh rate (default 6, the "
                         "reference's frame pacing)")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from . import config as config_mod

    cfg = (
        config_mod.from_toml(args.config)
        if args.config else config_mod.ReceiverConfig()
    )
    if not args.config:
        cfg = config_mod.ReceiverConfig(
            sdr=config_mod.SdrConfig(driver="synthetic",
                                     sample_rate_hz=4_096_000.0),
            rf=config_mod.RfConfig(freq_if_hz=0.0,
                                   output_sample_rate_hz=4_096_000.0),
            track=config_mod.TrackConfig(n_channels=8),
            block_ms=20,
        )
        print("no --config given: running the built-in synthetic scene",
              file=sys.stderr)

    from .receiver import Receiver

    source = build_source(cfg)
    rx = Receiver(cfg, source)
    if args.rinex_obs or args.ekf:
        try:
            rx.enable_observables(
                rinex_path=args.rinex_obs, every_ms=args.obs_every_ms,
                week=args.gps_week, ekf=args.ekf,
            )
        except OSError as e:
            raise SystemExit(f"cannot open --rinex-obs target: {e}")
    view = None
    if args.live or args.live_png:
        from .utils.live import LiveView

        view = LiveView(rx, png_path=args.live_png,
                        interval_s=1.0 / max(args.live_fps, 1e-3),
                        terminal=args.live, stream=sys.stderr)
    t0 = time.time()
    out = rx.run(max_blocks=args.blocks, on_block=view)
    wall = time.time() - t0
    if view is not None:
        view.refresh(force=True)   # final frame reflects the end state
    out["wall_s"] = round(wall, 3)
    out["realtime_factor"] = round(out["time_ms"] / 1000.0 / wall, 2)

    if args.pvt:
        sol = rx.compute_pvt()
        out["pvt"] = (
            None if sol is None else {
                "ecef_m": [round(v, 2) for v in sol.position_ecef_m],
                "lat_deg": round(sol.latitude_deg, 7),
                "lon_deg": round(sol.longitude_deg, 7),
                "height_m": round(sol.height_m, 2),
                "gdop": round(sol.gdop, 2),
            }
        )

    if args.json:
        print(json.dumps(out, default=str))
    else:
        print(f"processed {out['time_ms']/1000:.2f}s of signal in "
              f"{wall:.2f}s ({out['realtime_factor']}x realtime)")
        print(f"tracking PRNs: {out['tracked_prns']}")
        for ch in out["channels"]:
            cn0 = ch["cn0_dbhz"]
            print(f"  PRN {ch['prn']:3d}: epochs={ch['epochs']:6d} "
                  f"lock={ch['locked_fraction']:.2f} "
                  f"doppler={ch['last_doppler_hz'] or 0.0:+9.1f} Hz "
                  f"C/N0={'--' if cn0 is None else f'{cn0:.1f}'} dB-Hz")
        if out.get("ephemerides"):
            print(f"ephemerides decoded: {out['ephemerides']}")
        if args.pvt:
            print("PVT:", out["pvt"])

    if rx._obs_writer is not None:
        rx._obs_writer.close()
        print(f"observables -> {args.rinex_obs} "
              f"({rx._obs_writer.epochs_written} epochs)", file=sys.stderr)
    if args.ekf and rx.nav_filter is not None and rx.nav_filter.x is not None:
        print("ekf position:",
              [round(v, 1) for v in rx.nav_filter.position],
              file=sys.stderr)

    if args.dashboard:
        from .utils import plot_receiver_state

        plot_receiver_state(rx, args.dashboard)
        print(f"dashboard -> {args.dashboard}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
