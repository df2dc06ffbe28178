"""Capstone: a mixed GPS+Galileo+BeiDou+GLONASS position fix.

Four constellations, two satellites each, one RF stream: satellite
positions come from each system's own broadcast model (Kepler with the
system's GM/earth-rate; GLONASS PZ-90 state integration), the scene
bakes in per-satellite geometric delays, and the fused observables
(receiver/multi.py) solve one position with a per-system receiver
clock (nav/pvt.py). The reference CLAIMS this capability
(reference README.md:2) but implements GPS L1 C/A only.

Time anchors are injected directly, as in tests/test_pvt_end_to_end.py
(the live decode paths are separately gated: tests/test_nav_live.py for
GPS, tests/test_nav_live_multi.py for the other three).
"""
import numpy as np
import pytest

from gnss_sdr import constants as C
from gnss_sdr.config import AcqConfig, ReceiverConfig, RfConfig, TrackConfig
from gnss_sdr.models import SatelliteScenario
from gnss_sdr.models.constellation import (
    BEIDOU_B1I, GALILEO_E1B, GLONASS_L1OF, GPS_L1CA, get_signal,
)
from gnss_sdr.nav.ephemeris import Ephemeris
from gnss_sdr.nav.glonass_nav import GlonassEphemeris
from gnss_sdr.nav.orbits import satellite_position
from gnss_sdr.receiver import MultiConstellationReceiver, SyntheticSource
from gnss_sdr.receiver.navproc import TimeAnchor

FS = 4_092_000.0
CC = C.SPEED_OF_LIGHT_M_S
RX_TRUE = np.array([4_027_894.0, 307_045.7, 4_919_474.9])
T_REF = 432_000.0            # seconds of week (and of day for GLONASS)


def _enu_basis(p):
    up = p / np.linalg.norm(p)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    return east, north, up


def _sat_pos_at(az_deg, el_deg, radius_m):
    """ECEF point on the az/el ray from RX_TRUE at |pos| = radius."""
    east, north, up = _enu_basis(RX_TRUE)
    az, el = np.radians(az_deg), np.radians(el_deg)
    d = (np.cos(el) * np.sin(az) * east + np.cos(el) * np.cos(az) * north
         + np.sin(el) * up)
    # solve |RX + rho d| = radius
    b = 2.0 * np.dot(RX_TRUE, d)
    c0 = np.dot(RX_TRUE, RX_TRUE) - radius_m**2
    rho = (-b + np.sqrt(b * b - 4 * c0)) / 2.0
    return RX_TRUE + rho * d


def _kepler_ephemeris(prn, system, pos, radius_m, t_oe=T_REF):
    """Circular-orbit ephemeris whose position at t_oe is ``pos``.

    Solves (omega0, u) from the ICD's orbit-plane -> ECEF rotation so
    satellite_position(eph, t_oe) lands on ``pos`` exactly (e=0)."""
    from gnss_sdr.nav.orbits import _gm_omega

    _, omega_e = _gm_omega(system)
    g = pos / radius_m
    # the inclination must reach the target's z component (mid-latitude
    # receivers put high-elevation satellites near |g_z| ~ 0.9)
    i0 = max(np.radians(55.0), np.arcsin(min(abs(g[2]), 1.0)) + 0.1)
    su = np.clip(g[2] / np.sin(i0), -1.0, 1.0)
    for u in (np.arcsin(su), np.pi - np.arcsin(su)):
        a_, b_ = np.cos(u), np.sin(u) * np.cos(i0)
        om = np.arctan2(g[1], g[0]) - np.arctan2(b_, a_)
        e = Ephemeris(
            prn=prn, system=system, sqrt_a=np.sqrt(radius_m), e=0.0,
            m0=u, omega=0.0, i0=i0,
            omega0=om + omega_e * t_oe,
            t_oe=t_oe, t_oc=t_oe,
        )
        p, _, _ = satellite_position(e, t_oe)
        if np.linalg.norm(p - pos) < 1.0:
            return e
    raise AssertionError("placement failed")


def _glonass_ephemeris(prn, pos):
    # a plausible MEO velocity perpendicular-ish to the radius; the
    # scene is static (zero range rate) so only the position matters
    return GlonassEphemeris(
        prn=prn, pos_m=pos.astype(float), vel_m_s=np.zeros(3),
        acc_m_s2=np.zeros(3), t_b_s=T_REF % 86400.0, tau_n=0.0, nt=100,
    )


def _light_time(pos):
    tau = 0.07
    for _ in range(4):
        theta = C.OMEGA_E_DOT_RAD_S * tau
        rot = np.array([[np.cos(theta), np.sin(theta), 0],
                        [-np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
        tau = np.linalg.norm(rot @ pos - RX_TRUE) / CC
    return tau


@pytest.fixture(scope="module")
def mixed_fix():
    # 2-3 satellites per system, spread in azimuth/elevation (10 sats
    # vs 3+4 unknowns: enough redundancy that code-quantization jitter
    # is not geometry-amplified)
    # distinct per-satellite carrier Dopplers: a fully static zero-
    # Doppler scene leaves same-band CDMA cross-correlations at DC,
    # biasing every DLL by ±50-110 m persistently (the FDMA GLONASS
    # channels, spectrally isolated, measured < 7 m in the same scene).
    # Carrier offsets rotate the cross terms so they average out over
    # the run; code Doppler stays ZERO so the code-phase truth (and the
    # injected time anchors) remain exactly static.
    plan = [
        ("gps_l1ca", GPS_L1CA, 3, 26_560e3, (40.0, 55.0), "gps", 737.0),
        ("gps_l1ca", GPS_L1CA, 17, 26_560e3, (160.0, 35.0), "gps",
         -1291.0),
        ("gps_l1ca", GPS_L1CA, 28, 26_560e3, (300.0, 75.0), "gps",
         2143.0),
        ("galileo_e1b", GALILEO_E1B, 11, 29_600e3, (250.0, 60.0),
         "galileo", 941.0),
        ("galileo_e1b", GALILEO_E1B, 24, 29_600e3, (310.0, 30.0),
         "galileo", -1823.0),
        ("beidou_b1i", BEIDOU_B1I, 8, 27_906e3, (80.0, 70.0), "beidou",
         457.0),
        ("beidou_b1i", BEIDOU_B1I, 21, 27_906e3, (200.0, 25.0),
         "beidou", 1531.0),
        ("beidou_b1i", BEIDOU_B1I, 30, 27_906e3, (140.0, 50.0),
         "beidou", -659.0),
        ("glonass_l1of", GLONASS_L1OF, 7, 25_508e3, (120.0, 45.0),
         "glonass", 1097.0),     # FDMA channel -1 -> pseudo-PRN 7
        ("glonass_l1of", GLONASS_L1OF, 11, 25_508e3, (0.0, 50.0),
         "glonass", -353.0),     # FDMA channel +3 -> pseudo-PRN 11
    ]
    scenarios = []
    truth = {}           # (signal, prn) -> dict
    for sig_name, spec, prn, radius, (az, el), system, dop in plan:
        pos = _sat_pos_at(az, el, radius)
        if system == "glonass":
            eph = _glonass_ephemeris(prn, pos)
            t_ref_sys = T_REF % 86400.0
        else:
            eph = _kepler_ephemeris(prn, system, pos, radius)
            t_ref_sys = T_REF
        tau = _light_time(pos)
        t_tx0 = t_ref_sys - tau          # clk = 0 by construction
        period_s = spec.code_period_s
        cp0 = (t_tx0 % period_s) * spec.code_rate_hz
        if sig_name == "glonass_l1of":
            k = list(range(-7, 7))[prn - 1]
            dop += k * 562_500.0
        scenarios.append(SatelliteScenario(
            prn=prn, doppler_hz=dop, code_phase_chips=cp0,
            amplitude=0.3, signal=spec,
        ))
        truth[(sig_name, prn)] = {
            "eph": eph, "t_tx0": t_tx0, "cp0": cp0, "spec": spec,
        }

    source = SyntheticSource(scenarios, FS, noise_std=1.0, seed=41,
                             total_samples=int(1.2 * FS))
    configs = {
        "gps_l1ca": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(signal="gps_l1ca", detection_threshold=20.0),
            track=TrackConfig(signal="gps_l1ca", n_channels=4),
            block_ms=20,
        ),
        "galileo_e1b": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            # 8 satellites share the stream: cross-correlation false
            # alarms reach ratio ~15 at 16 ms; true peaks are ~800
            acq=AcqConfig(signal="galileo_e1b", n_prn=36,
                          non_coherent_ms=16, detection_threshold=40.0),
            track=TrackConfig(signal="galileo_e1b", n_channels=4),
            block_ms=20,
        ),
        "beidou_b1i": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(signal="beidou_b1i", n_prn=37,
                          detection_threshold=40.0),
            track=TrackConfig(signal="beidou_b1i", n_channels=4),
            block_ms=20,
        ),
        "glonass_l1of": ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(signal="glonass_l1of", n_prn=14,
                          fdma_spacing_hz=562_500.0,
                          fdma_channels=tuple(range(-7, 7)),
                          detection_threshold=20.0),
            track=TrackConfig(signal="glonass_l1of", n_channels=4),
            block_ms=20,
        ),
    }
    mrx = MultiConstellationReceiver(configs, source)
    mrx.run()

    # inject time anchors + ephemerides (static scene: zero range rate)
    for name, rx in mrx.receivers.items():
        for prn, ch in rx.active.items():
            t = truth[(name, prn)]
            trace = [tr for tr in rx.telemetry.all_traces()
                     if tr.prn == prn][0]
            g0 = int(trace.global_sample[0])
            spec = t["spec"]
            t_tx_g0 = t["t_tx0"] + g0 / FS
            rate_eff = spec.code_rate_hz
            cp_g0 = (t["cp0"] + rate_eff / FS * g0) % spec.code_length_chips
            half = spec.code_length_chips / 2
            delta = cp_g0 if cp_g0 < half else cp_g0 - spec.code_length_chips
            e0 = int(trace.epoch_index[0])
            rx.nav.channels[ch].anchor = TimeAnchor(
                epoch=e0, global_sample=g0,
                tow_s=t_tx_g0, chip_phase=delta,
            )
            rx.nav.ephemerides[prn] = t["eph"]

    # the scene is STATIC (frozen code phases, zero range rate) but a
    # Kepler ephemeris moves its satellite ~3.9 km/s; evaluated ~1.2 s
    # after t_oe that is a ~1 km per-satellite pseudorange spread. Pin
    # each Kepler ephemeris' t_oe to the transmit time the fused
    # observables actually use, so the model reproduces the static
    # scene positions at the measurement epoch (anchors fix the txs, so
    # this re-injection does not change the observables themselves).
    sig_of = {"gps": "gps_l1ca", "galileo": "galileo_e1b",
              "beidou": "beidou_b1i", "glonass": "glonass_l1of"}
    obs = mrx.observables()
    assert obs is not None
    for prn, system, tx in zip(obs["prns"], obs["systems"],
                               obs["transmit_times_s"]):
        if system == "glonass":
            continue                 # static state vector already
        name = sig_of[system]
        t = truth[(name, prn)]
        pos = satellite_position(t["eph"], t["eph"].t_oe)[0]
        radius = np.linalg.norm(pos)
        eph2 = _kepler_ephemeris(prn, system, pos, radius, t_oe=tx)
        t["eph"] = eph2
        mrx.receivers[name].nav.ephemerides[prn] = eph2
    return mrx, truth


class TestMixedConstellationPvt:
    def test_all_systems_tracked(self, mixed_fix):
        mrx, truth = mixed_fix
        for name, rx in mrx.receivers.items():
            want = sorted(p for (n, p) in truth if n == name)
            assert sorted(rx.active) == want, (name, rx.active)

    def test_fused_observables_cover_four_systems(self, mixed_fix):
        mrx, _ = mixed_fix
        obs = mrx.observables()
        assert obs is not None
        assert len(obs["prns"]) == 10
        assert set(obs["systems"]) == {"gps", "galileo", "beidou",
                                       "glonass"}

    def test_mixed_fix_accuracy(self, mixed_fix):
        mrx, _ = mixed_fix
        sol = mrx.compute_pvt()
        assert sol is not None
        err = np.linalg.norm(sol.position_ecef_m - RX_TRUE)
        # 100 m bound: the capstone gate proves four-system fusion with
        # per-system clocks, not single-system precision (that is gated
        # at 13.5 m in tests/test_full_chain_live.py). At one shared
        # 4.092 MHz front end, BeiDou runs at 2 samples/chip and
        # Galileo BOC(1,1) at 4 — DLL quantization leaves ~20-60 m of
        # intra-system spread (measured), i.e. a few tens of meters of
        # position error at this geometry.
        assert err < 100.0, f"mixed-constellation fix error {err:.1f} m"
        assert set(sol.clock_bias_by_system_m) == {
            "gps", "galileo", "beidou", "glonass"}
        # all systems share one scene timeline, so inter-system biases
        # are bounded by code-phase quantization — EXCEPT the known
        # GLONASS day-of-week convention: its transmit times are
        # day-referenced (T_REF % 86400), i.e. exactly 432000 s behind
        # the week-referenced systems here, and that constant lands in
        # its clock bias (this is precisely what the per-system clock
        # unknown exists to absorb).
        b = dict(sol.clock_bias_by_system_m)
        b["glonass"] -= 432_000.0 * CC
        biases = np.array(list(b.values()))
        assert np.all(np.abs(biases - biases.mean()) < 300.0), b
