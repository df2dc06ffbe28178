"""RINEX observation writer round-trip + EKF navigation filter."""
import datetime
import os

import numpy as np
import pytest

from gnss_sdr import constants as C
from gnss_sdr.nav import (
    NavigationFilter,
    RinexObsWriter,
    parse_obs_file,
    parse_nav_file,
    satellite_position,
    select_ephemerides,
)

RINEX_PATH = "/root/reference/src/test_data/BRDC00WRD_R_20233330000_01D_GN.rnx"
CC = C.SPEED_OF_LIGHT_M_S


class TestRinexObsWriter:
    def test_roundtrip(self, tmp_path):
        p = tmp_path / "obs.rnx"
        with RinexObsWriter(str(p), marker_name="TESTMARK",
                            approx_position=(4e6, 3e5, 4.9e6)) as w:
            for k in range(5):
                w.write_epoch(2290, 331500.0 + 0.1 * k, {
                    4: (21_000_000.0 + k, -1234.5, 45.0),
                    16: (23_456_789.012, 987.6, None),
                })
        header, epochs = parse_obs_file(str(p))
        assert header["version"].startswith("3")
        assert header["marker"] == "TESTMARK"
        assert header["obs_types"] == ["C1C", "D1C", "S1C"]
        assert len(epochs) == 5
        e0 = epochs[0]
        assert set(e0["sats"]) == {4, 16}
        assert e0["sats"][4][0] == pytest.approx(21_000_000.0, abs=1e-3)
        assert e0["sats"][4][1] == pytest.approx(-1234.5, abs=1e-3)
        assert e0["sats"][16][2] is None
        # epoch timestamps advance by 0.1 s
        dt = (epochs[1]["time"] - epochs[0]["time"]).total_seconds()
        assert dt == pytest.approx(0.1, abs=1e-6)

    def test_receiver_observables_stream_to_rinex(self, tmp_path):
        """Receiver observables -> RINEX OBS file (config ladder 5:
        'RINEX observables at streaming rate')."""
        if not os.path.exists(RINEX_PATH):
            pytest.skip("reference RINEX data absent")
        import conftest  # noqa: F401
        from test_pvt_end_to_end import build_solved

        # reuse the already-validated solved-scene helper directly
        rx, sol, sats = build_solved()
        obs = rx.nav.observables()
        assert obs is not None
        p = tmp_path / "rx_obs.rnx"
        with RinexObsWriter(str(p)) as w:
            w.write_epoch(
                2290, obs["rx_time_nominal_s"],
                {prn: (pr, 0.0, 45.0)
                 for prn, pr in zip(obs["prns"], obs["pseudoranges_m"])},
            )
        header, epochs = parse_obs_file(str(p))
        assert len(epochs) == 1
        assert set(epochs[0]["sats"]) == set(obs["prns"])


@pytest.mark.skipif(
    not os.path.exists(RINEX_PATH), reason="reference RINEX data absent"
)
class TestNavigationFilter:
    def _observable_series(self, n_epochs=20, dt=1.0, noise=8.0,
                           vel=np.zeros(3)):
        _, records = parse_nav_file(RINEX_PATH)
        at = datetime.datetime(2023, 11, 29, 16, 30,
                               tzinfo=datetime.timezone.utc)
        ephs = list(select_ephemerides(records, at).values())[:6]
        rx0 = np.array([4_027_894.0, 307_045.7, 4_919_474.9])
        rng = np.random.default_rng(0)
        series = []
        for k in range(n_epochs):
            rx = rx0 + vel * (k * dt)
            prs, txs = [], []
            for eph in ephs:
                t_tx = eph.t_oe + 600.0 + k * dt
                pos, _, clk = satellite_position(eph, t_tx)
                r = np.linalg.norm(pos - rx)
                for _ in range(3):
                    tof = r / CC
                    rot_pos = np.array([
                        [np.cos(C.OMEGA_E_DOT_RAD_S * tof),
                         np.sin(C.OMEGA_E_DOT_RAD_S * tof), 0],
                        [-np.sin(C.OMEGA_E_DOT_RAD_S * tof),
                         np.cos(C.OMEGA_E_DOT_RAD_S * tof), 0],
                        [0, 0, 1]]) @ pos
                    r = np.linalg.norm(rot_pos - rx)
                prs.append(r + 5000.0 - CC * clk + rng.normal(0, noise))
                txs.append(t_tx)
            series.append((prs, ephs, txs, rx))
        return series

    def test_filter_beats_snapshot(self):
        from gnss_sdr.nav import solve_pvt

        series = self._observable_series()
        ekf = NavigationFilter(sigma_pr=8.0)
        snap_errs, ekf_errs = [], []
        last_t = None
        for prs, ephs, txs, rx_true in series:
            if last_t is not None:
                ekf.predict(1.0)
            last_t = txs[0]
            assert ekf.update(prs, ephs, txs)
            sol = solve_pvt(prs, ephs, txs)
            snap_errs.append(np.linalg.norm(sol.position_ecef_m - rx_true))
            ekf_errs.append(np.linalg.norm(ekf.position - rx_true))
        # after convergence the filtered errors beat snapshot on average
        assert np.mean(ekf_errs[5:]) < np.mean(snap_errs[5:])
        assert np.mean(ekf_errs[-5:]) < 30.0

    def test_filter_rides_through_short_epochs(self):
        series = self._observable_series(n_epochs=10)
        ekf = NavigationFilter()
        for k, (prs, ephs, txs, rx_true) in enumerate(series):
            if k:
                ekf.predict(1.0)
            if k == 5:
                # only 3 satellites this epoch: snapshot would fail,
                # the filter still updates
                assert ekf.update(prs[:3], ephs[:3], txs[:3])
            else:
                ekf.update(prs, ephs, txs)
        assert np.linalg.norm(ekf.position - series[-1][3]) < 60.0

    def test_velocity_estimated_with_doppler(self):
        vel = np.array([5.0, -3.0, 2.0])
        series = self._observable_series(n_epochs=15, vel=vel, noise=5.0)
        ekf = NavigationFilter()
        for k, (prs, ephs, txs, rx_true) in enumerate(series):
            if k:
                ekf.predict(1.0)
            # doppler from geometry: rr = (v_rx - v_sat).los
            dops = []
            for eph, t_tx in zip(ephs, txs):
                pos, svel, _ = satellite_position(eph, t_tx)
                los = (rx_true - pos)
                los = los / np.linalg.norm(los)
                rr = np.dot(vel - svel, los)
                dops.append(-rr / (CC / 1_575_420_000.0))
            ekf.update(prs, ephs, txs, dopplers_hz=dops)
        assert np.linalg.norm(ekf.velocity - vel) < 1.0
