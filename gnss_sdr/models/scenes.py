"""Seeded scenes for the chip smoke run and the benchmark.

Three deployments, each rendered from a seed by the float64 synthesis
oracle (models/signal.py), so no capture blob is needed:

  * ``gps24``: 24 GPS L1 C/A satellites for a 32-channel receiver;
  * ``mixed32``: 16 satellites of four constellations (GPS L1 C/A,
    Galileo E1B, GLONASS L1OF, BeiDou B1I) for a 32-channel receiver;
  * ``live_lnav``: 6 GPS satellites on Keplerian orbits broadcasting
    their own ephemerides as genuine LNAV frames, timed on the GPS
    timeline, so a receiver that decodes the bits can fix its position
    (truth ``RX_TRUE``). Self-contained: the orbits are circular
    ephemerides placed at chosen azimuths and elevations.

``render`` synthesizes long streams in parallel chunks (exact phase
continuity across chunks; the noise is seeded per chunk).
"""
from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from .. import constants as C
from .constellation import BEIDOU_B1I, GALILEO_E1B, GLONASS_L1OF, GPS_L1CA
from .signal import SatelliteScenario, synthesize

RX_TRUE = np.array([4_027_894.0, 307_045.7, 4_919_474.9])
T_OE = 432_000.0          # seconds of week; a multiple of 16 s and 6 s
_CC = C.SPEED_OF_LIGHT_M_S
_CODE_RATE = C.GPS_L1_CA_CODE_RATE_CHIPS_PER_S


def render(sats, n_samples: int, fs_hz: float, f_if_hz: float = 0.0,
           noise_std: float = 1.0, seed: int = 0, chunk: int = 1 << 22,
           workers: int | None = None) -> np.ndarray:
    """``synthesize`` over ``n_samples``, in parallel chunks."""
    starts = list(range(0, n_samples, chunk))
    out = np.empty(n_samples, np.complex64)

    def one(k):
        s = starts[k]
        n = min(chunk, n_samples - s)
        out[s:s + n] = synthesize(sats, n, fs_hz, f_if_hz, noise_std,
                                  seed=seed * 100_003 + k, start_sample=s)

    workers = workers or min(16, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(one, range(len(starts))))
    return out


def write_real_if_int8(path, sats, n_samples: int, fs_hz: float,
                       f_if_hz: float, noise_std: float = 1.0,
                       seed: int = 0, scale: float = 20.0,
                       chunk: int = 1 << 22) -> None:
    """Write an int8 real-IF capture (the bundled-capture wire format,
    ``synthesize_real_if_int8``) chunk by chunk, rendered in parallel."""
    starts = list(range(0, n_samples, chunk))

    def one(k):
        s = starts[k]
        cx = synthesize(sats, min(chunk, n_samples - s), fs_hz, f_if_hz,
                        noise_std, seed=seed * 100_003 + k, start_sample=s)
        return np.clip(np.round(np.real(cx) * scale), -127, 127).astype(
            np.int8)

    workers = min(16, os.cpu_count() or 1)
    with open(path, "wb") as f, \
            concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for part in pool.map(one, range(len(starts))):
            f.write(part.tobytes())


def gps24() -> list[SatelliteScenario]:
    """24 GPS satellites, Dopplers within +-2 kHz, spread code phases."""
    return [
        SatelliteScenario(
            prn=p, doppler_hz=float(500.0 * ((p % 7) - 3) + (100 * p) % 900),
            code_phase_chips=float((37 * p) % 1023), amplitude=0.3)
        for p in range(1, 25)
    ]


def mixed32() -> list[SatelliteScenario]:
    """GPS 6 + Galileo E1B 2 + GLONASS L1OF 2 (FDMA channels +2, -3) +
    BeiDou B1I 4, one 8.184 MHz stream."""
    return (
        [SatelliteScenario(prn=p, doppler_hz=float(400.0 * ((p % 5) - 2)),
                           code_phase_chips=float((37 * p) % 1023),
                           amplitude=0.25, signal=GPS_L1CA)
         for p in (2, 5, 9, 14, 21, 28)]
        + [SatelliteScenario(prn=p, doppler_hz=float(300.0 * (p % 3) - 300),
                             amplitude=0.22, signal=GALILEO_E1B)
           for p in (11, 19)]
        + [SatelliteScenario(prn=1, doppler_hz=2 * 562_500.0 - 1200.0,
                             amplitude=0.3, signal=GLONASS_L1OF),
           SatelliteScenario(prn=2, doppler_hz=-3 * 562_500.0 + 800.0,
                             amplitude=0.3, signal=GLONASS_L1OF)]
        + [SatelliteScenario(prn=p, doppler_hz=float(250.0 * (p % 4) - 500),
                             amplitude=0.28, signal=BEIDOU_B1I)
           for p in (6, 12, 27, 33)]
    )


# -- live LNAV scene -------------------------------------------------------

# (PRN, azimuth deg, elevation deg) at T_OE
_LIVE_PLAN = ((3, 40.0, 55.0), (8, 160.0, 35.0), (14, 300.0, 75.0),
              (19, 100.0, 28.0), (23, 220.0, 60.0), (30, 340.0, 32.0))
_GPS_RADIUS_M = 26_560e3


def _sat_pos_at(az_deg, el_deg, radius_m):
    """ECEF point on the az/el ray from RX_TRUE at |pos| = radius."""
    up = RX_TRUE / np.linalg.norm(RX_TRUE)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    az, el = np.radians(az_deg), np.radians(el_deg)
    d = (np.cos(el) * np.sin(az) * east + np.cos(el) * np.cos(az) * north
         + np.sin(el) * up)
    b = 2.0 * np.dot(RX_TRUE, d)
    c0 = np.dot(RX_TRUE, RX_TRUE) - radius_m**2
    return RX_TRUE + (-b + np.sqrt(b * b - 4 * c0)) / 2.0 * d


def _wrap_pi(x):
    return float((x + np.pi) % (2.0 * np.pi) - np.pi)


def _kepler_ephemeris(prn, pos, radius_m):
    """Circular-orbit GPS ephemeris whose position at T_OE is ``pos``."""
    from ..nav.ephemeris import Ephemeris
    from ..nav.orbits import satellite_position

    g = pos / radius_m
    i0 = max(np.radians(55.0), np.arcsin(min(abs(g[2]), 1.0)) + 0.1)
    su = np.clip(g[2] / np.sin(i0), -1.0, 1.0)
    for u in (np.arcsin(su), np.pi - np.arcsin(su)):
        a_, b_ = np.cos(u), np.sin(u) * np.cos(i0)
        om = np.arctan2(g[1], g[0]) - np.arctan2(b_, a_)
        e = Ephemeris(
            prn=prn, week=242, iodc=7, iode=7, sqrt_a=np.sqrt(radius_m),
            e=0.0, m0=_wrap_pi(u), omega=0.0, i0=float(i0),
            omega0=_wrap_pi(om + C.OMEGA_E_DOT_RAD_S * T_OE),
            t_oe=T_OE, t_oc=T_OE)
        p, _, _ = satellite_position(e, T_OE)
        if np.linalg.norm(p - pos) < 1.0:
            return e
    raise AssertionError("satellite placement failed")


def _signal_time(eph, t_rx):
    """(SV-clock transmit time, light time) of the signal received at
    true time ``t_rx`` by RX_TRUE (Sagnac-rotated light-time
    iteration, the PVT solver's model)."""
    from ..nav.orbits import satellite_position

    tau = 0.075
    for _ in range(5):
        pos, _, clk = satellite_position(eph, t_rx - tau)
        th = C.OMEGA_E_DOT_RAD_S * tau
        rot = np.array([[np.cos(th), np.sin(th), 0.0],
                        [-np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
        tau = np.linalg.norm(rot @ pos - RX_TRUE) / _CC
    return t_rx - tau + clk, tau


def live_lnav(eph_reps: int = 1, amplitude: float = 0.3, seed: int = 17):
    """(scenarios, ephemerides {prn: Ephemeris}, total_s).

    Sample 0 is received at GPS time ``T_OE + 5.5`` s; each satellite's
    bits start at the SV second before the next subframe boundary (one
    filler second), then a dummy subframe 4, ``eph_reps`` copies of
    subframes 1-3 and a closing subframe 4. Code and carrier follow the
    secant range rate over the scene, so the modelled delay is exact at
    both ends (where the fix is taken)."""
    from ..nav import encode_frames, encode_words

    t0 = T_OE + 5.5
    boundary = int(T_OE) + 6
    total_s = (boundary - (t0 - 0.5)) + 6.0 * (1 + 3 * eph_reps) + 2.0
    rng = np.random.default_rng(seed)
    scenarios, ephs = [], {}
    for prn, az, el in _LIVE_PLAN:
        eph = _kepler_ephemeris(prn, _sat_pos_at(az, el, _GPS_RADIUS_M),
                                _GPS_RADIUS_M)
        t_tx0, tau0 = _signal_time(eph, t0)
        _, tau1 = _signal_time(eph, t0 + total_s)
        s0 = int(np.floor(t_tx0))
        if s0 != boundary - 1:
            raise AssertionError(f"PRN {prn}: SV second {s0}")
        rate = 1.0 - (tau1 - tau0) / total_s        # d(t_tx)/d(t_rx)
        m_idx = boundary // 6
        frames = [(4, m_idx + 1, rng.integers(0, 2, (8, 24)).astype(
            np.uint8))]
        nxt = m_idx + 2
        for _ in range(eph_reps):
            frames += [(sid, nxt + sid - 1, encode_words(eph, sid))
                       for sid in (1, 2, 3)]
            nxt += 3
        frames.append((4, nxt, rng.integers(0, 2, (8, 24)).astype(
            np.uint8)))
        filler = rng.choice([-1, 1], (boundary - s0) * 50).astype(np.int8)
        scenarios.append(SatelliteScenario(
            prn=prn, doppler_hz=(rate - 1.0) * C.GPS_L1_FREQ_HZ,
            code_phase_chips=(t_tx0 % 1.0) * _CODE_RATE,
            amplitude=amplitude, code_rate_offset_hz=(rate - 1.0)
            * _CODE_RATE,
            nav_bits=np.concatenate([filler, encode_frames(frames)])))
        ephs[prn] = eph
    return scenarios, ephs, total_s
