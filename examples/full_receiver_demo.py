"""Full-chain demo: synthetic sky with real LNAV broadcasts -> cold
start -> acquisition -> tracking -> live ephemeris decode -> dashboard.

Run: PYTHONPATH=. python examples/full_receiver_demo.py [--cpu]
(on a GPU by default; --cpu for the CPU reference platform)
"""
import argparse
import time

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true")
ap.add_argument("--seconds", type=float, default=26.0)
args = ap.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

from gnss_sdr import ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario
from gnss_sdr.nav import Ephemeris, encode_frames, encode_words
from gnss_sdr.receiver import Receiver, SyntheticSource
from gnss_sdr.utils import plot_receiver_state

FS = 2_046_000.0

eph = Ephemeris(
    prn=7, week=290, iodc=66, iode=66, t_gd=5.1e-09, t_oc=316800.0,
    a_f1=3.4e-13, a_f0=1.63e-04, c_rs=-45.2, delta_n=4.0e-09, m0=1.22,
    c_uc=-2.5e-06, e=0.013, c_us=5.3e-07, sqrt_a=5154.02, t_oe=316784.0,
    c_ic=-2.2e-07, omega0=-0.985, c_is=3.5e-08, i0=0.990, c_rc=387.3,
    omega=1.0, omega_dot=-8.3e-09, idot=-2e-10,
)
rng = np.random.default_rng(1)
frames = (
    [(4, 500, rng.integers(0, 2, (8, 24)).astype(np.uint8))]
    + [(s, 500 + s, encode_words(eph, s)) for s in (1, 2, 3)]
    + [(4, 504, rng.integers(0, 2, (8, 24)).astype(np.uint8))]
)
sats = [
    SatelliteScenario(prn=7, doppler_hz=1234.0, amplitude=0.25,
                      nav_bits=encode_frames(frames)),
    SatelliteScenario(prn=18, doppler_hz=-2800.0, amplitude=0.22,
                      code_phase_chips=512.0),
]
src = SyntheticSource(sats, FS, noise_std=1.0, seed=7,
                      total_samples=int(args.seconds * FS))
rx = Receiver(
    ReceiverConfig(rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                   track=TrackConfig(n_channels=8), block_ms=100),
    src,
)
t0 = time.time()
out = rx.run()
wall = time.time() - t0
print(f"{out['time_ms']/1000:.1f}s of signal in {wall:.1f}s wall "
      f"({out['time_ms']/1000/wall:.1f}x realtime)")
print("tracked:", out["tracked_prns"], " nav:", out["nav"])
for prn, e in rx.nav.ephemerides.items():
    print(f"decoded ephemeris PRN {prn}: sqrt_a={e.sqrt_a:.3f} e={e.e:.5f} "
          f"week={e.week}")
plot_receiver_state(rx, "receiver_dashboard.png")
print("dashboard -> receiver_dashboard.png")
