"""The block tracking step (ops/pallas/track_step.py, interpreted on the
CPU) against the XLA reference ``receiver.tracking.track_block``, plus
the ledger rules of the span program around it (fused_runner), the
platform rule and the compile-cache path.

Agreement rules: gnss_sdr/utils/parity.py (exact integer bookkeeping,
summation-order tolerance on the sums and loop outputs)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnss_sdr.config import TrackConfig
from gnss_sdr.models import SatelliteScenario, synthesize
from gnss_sdr.models.constellation import get_signal
from gnss_sdr.ops.pallas import track_step as ts
from gnss_sdr.receiver import fused_runner as fr
from gnss_sdr.receiver import tracking as trk
from gnss_sdr.utils import parity, platform

GPS_FS = 2_046_000.0


def _scene(signal="gps_l1ca", fs=GPS_FS, n_ch=3, t_epochs=6, track_kw=None,
           amplitude=0.3, seed=4):
    spec = get_signal(signal)
    cfg = TrackConfig(n_channels=n_ch, correlator="fused",
                      **(track_kw or {}))
    params = trk.TrackParams.create(cfg, spec, fs)
    n_prn = min(spec.n_prn, 8)
    table = trk.make_sampled_code_table(spec, fs, n_prn,
                                        window=params.window)
    n0 = spec.samples_per_code(fs)
    prns = [1 + (ch % n_prn) for ch in range(n_ch)]
    dops = [600.0 + 170.0 * ch for ch in range(n_ch)]
    buf = (t_epochs + 3) * n0
    # one scenario per distinct PRN (channels beyond n_prn share one)
    scen = {p: SatelliteScenario(prn=p, doppler_hz=d, amplitude=amplitude,
                                 signal=spec)
            for p, d in zip(prns, dops)}
    sig = synthesize(list(scen.values()), buf + 4 * n0, fs,
                     noise_std=0.5, seed=seed)
    st = trk.init_state(n_ch)
    for ch in range(n_ch):
        st = trk.start_channel(st, ch, prns[ch] - 1,
                               scen[prns[ch]].doppler_hz,
                               n0 + 29 + 37 * ch, spec.code_rate_hz)
    rows = table[np.asarray(prns) - 1]
    return dict(spec=spec, cfg=cfg, params=params, table=table, rows=rows,
                n0=n0, buf=buf, t=t_epochs, state=st,
                sre=jnp.asarray(np.real(sig), jnp.float32),
                sim=jnp.asarray(np.imag(sig), jnp.float32))


def _both(sc, state=None, base=0):
    state = sc["state"] if state is None else state
    b = slice(base, base + sc["buf"])
    ref = trk.track_block(sc["params"], sc["rows"], state, sc["sre"][b],
                          sc["sim"][b], sc["t"])
    got = ts.track_block_triton(sc["params"], sc["rows"], state, sc["sre"],
                                sc["sim"], jnp.int32(base),
                                t_epochs=sc["t"], buf_len=sc["buf"],
                                interpret=True)
    return ref, got


def _assert_agree(sc, ref, got):
    bad = parity.track_mismatches(ref, got, sc["spec"].code_length_chips)
    assert bad == {}, bad


# -- the step against the reference ---------------------------------------

@pytest.mark.parametrize("signal,fs", [
    ("gps_l1ca", GPS_FS),
    ("galileo_e1b", 4_092_000.0),
    ("beidou_b1i", 4_092_000.0),
    ("glonass_l1of", GPS_FS),
])
def test_signal_matches_reference(signal, fs):
    sc = _scene(signal, fs, t_epochs=3 if signal == "galileo_e1b" else 6)
    ref, got = _both(sc)
    assert np.asarray(ref[1].processed).all()
    _assert_agree(sc, ref, got)


@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("aiding", [False, True])
@pytest.mark.parametrize("lock_mode", ["power", "costas"])
def test_loop_modes_match_reference(lock_mode, aiding, interp):
    sc = _scene(track_kw=dict(lock_mode=lock_mode, carrier_aiding=aiding,
                              interp_code=interp))
    _assert_agree(sc, *_both(sc))


@pytest.mark.parametrize("n_ch", [1, 3, 5, 7])
def test_any_channel_count(n_ch):
    """One program per channel: counts that are not a power of two or a
    multiple of any group need no padding."""
    sc = _scene(n_ch=n_ch, t_epochs=4)
    ref, got = _both(sc)
    assert got[1].i_p.shape == (4, n_ch)
    _assert_agree(sc, ref, got)


def test_window_base_offset():
    """The step reads its window at ``base`` inside a longer stream."""
    sc = _scene(t_epochs=4)
    n0 = sc["n0"]
    _assert_agree(sc, *_both(sc, base=2 * n0 + 5))


def test_lost_channel_and_idle_rows():
    """A channel that loses lock mid-block: lost event, prn_idx -1 and
    the zeroed loop state match the reference; idle rows stay idle."""
    # no signal, and a power threshold above the noise's prompt power
    sc = _scene(n_ch=3, t_epochs=8, amplitude=0.0,
                track_kw=dict(max_lost_epochs=3, lock_threshold=1e5))
    st = sc["state"]._replace(
        active=jnp.asarray([True, True, False]))
    ref, got = _both(sc, state=st)
    assert np.asarray(ref[1].lost_event).any()
    assert list(np.asarray(got[0].prn_idx)) == list(
        np.asarray(ref[0].prn_idx))
    _assert_agree(sc, ref, got)
    # unprocessed epochs carry zero sums in the kernel's telemetry
    idle = ~np.asarray(got[1].processed)
    assert np.all(np.asarray(got[1].i_p)[idle] == 0.0)


@pytest.mark.parametrize("x", [
    0.5, 1.5, 2.5, -0.5, -1.5, 2046.4999, 2046.5, 2047.5, 1e9, 3.0, -7.25])
def test_round_half_even_matches_jnp_round(x):
    v = jnp.float32(x)
    assert float(ts._round_half_even(v)) == float(jnp.round(v))


@pytest.mark.parametrize("window,chunk", [
    (100, 128), (2054, 512), (4096, 512), (8192, 1024), (32744, 1024)])
def test_default_chunk(window, chunk):
    assert ts.default_chunk(window) == chunk


# -- the span program's ledger rules --------------------------------------

def _tracker(sc, **kw):
    block = sc["t"] * sc["n0"]
    history = sc["buf"] - block
    return fr.FusedTracker(sc["params"], sc["cfg"], sc["spec"], GPS_FS,
                           sc["table"], sc["t"], history + block, **kw)


@pytest.mark.parametrize("skip", [1, 3])
def test_offset_walk_counts_skipped_periods(skip):
    """A channel whose offset fell below the window skips whole code
    periods and counts each in its epoch base: the step then runs the
    reference arithmetic from the walked ledger."""
    sc = _scene(n_ch=2, t_epochs=4)
    ft = _tracker(sc)
    n0 = sc["n0"]
    st = sc["state"]._replace(
        offset=jnp.asarray([29 - skip * n0 + 1, n0 + 66], jnp.int32),
        epochs=jnp.asarray([10, 10], jnp.int32))
    got_state, (telem,) = ft.run_blocks(st, sc["sre"][:sc["buf"]],
                                        sc["sim"][:sc["buf"]], sc["rows"], 1)
    walked = st._replace(
        offset=jnp.asarray([29 + 1, n0 + 66], jnp.int32),
        epochs=jnp.asarray([10 + skip, 10], jnp.int32))
    ref_state, ref_telem = trk.track_block(
        sc["params"], sc["rows"], walked, sc["sre"][:sc["buf"]],
        sc["sim"][:sc["buf"]], sc["t"])
    ref_state = ref_state._replace(
        offset=ref_state.offset - sc["t"] * n0)      # the span rebases
    assert int(np.asarray(telem.epoch_index)[0, 0]) == 10 + skip
    _assert_agree(sc, (ref_state, ref_telem), (got_state, telem))


@pytest.mark.parametrize("wire", ["f32", "slim"])
def test_deferred_channel_untouched(wire):
    """A channel that cannot fit T epochs is deferred: its ledger passes
    through (rebased) and its telemetry is unprocessed, while the other
    channels run the reference arithmetic."""
    sc = _scene(n_ch=2, t_epochs=4)
    ft = _tracker(sc, wire=wire)
    late = int(ft.max_offset) + 7
    st = sc["state"]._replace(
        offset=jnp.asarray([sc["n0"] + 29, late], jnp.int32))
    got_state, (telem,) = ft.run_blocks(st, sc["sre"][:sc["buf"]],
                                        sc["sim"][:sc["buf"]], sc["rows"], 1)
    assert not telem.processed[:, 1].any()
    assert telem.processed[:, 0].all()
    block = sc["t"] * sc["n0"]
    assert int(got_state.offset[1]) == late - block
    for f in trk.ChannelState._fields:
        if f != "offset":
            assert np.asarray(getattr(got_state, f))[1] == np.asarray(
                getattr(st, f))[1], f
    ref_state, ref_telem = trk.track_block(
        sc["params"], sc["rows"], st._replace(
            active=jnp.asarray([True, False])),
        sc["sre"][:sc["buf"]], sc["sim"][:sc["buf"]], sc["t"])
    np.testing.assert_allclose(telem.i_p[:, 0], ref_telem.i_p[:, 0],
                               rtol=1e-2)
    assert int(got_state.offset[0]) == int(ref_state.offset[0]) - block


def test_device_handoff_matches_start_channel():
    sc = _scene(n_ch=4, t_epochs=4)
    ft = _tracker(sc)
    led = ft._as_ledger(trk.init_state(4))
    led = ft.apply_handoffs_device(led, [2, 0], [1234.5, -250.0],
                                   [4000, 5000])
    ref = trk.init_state(4)
    ref = trk.start_channel(ref, 2, -1, 1234.5, 4000,
                            sc["spec"].code_rate_hz)
    ref = trk.start_channel(ref, 0, -1, -250.0, 5000,
                            sc["spec"].code_rate_hz)
    for f in trk.ChannelState._fields:
        if f == "prn_idx":        # PRN bookkeeping stays host-side
            continue
        np.testing.assert_array_equal(np.asarray(getattr(led, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


# -- platform rule and compile cache --------------------------------------

@pytest.mark.parametrize("name,interpret", [
    ("cpu", True), ("gpu", False), ("mystery", None)])
def test_platform_rule(monkeypatch, name, interpret):
    """Interpret mode on the CPU only; a GPU compiles; any other
    platform is an error, never treated as an accelerator."""
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    if interpret is None:
        with pytest.raises(RuntimeError, match="unsupported"):
            platform.interpret_kernels()
    else:
        assert platform.interpret_kernels() is interpret


@pytest.mark.parametrize("env,expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/data/xla-cache"}, "/data/xla-cache"),
    ({}, str(platform.DEFAULT_CACHE_DIR)),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(platform.DEFAULT_CACHE_DIR)),
])
def test_compile_cache_dir(env, expect):
    assert platform.compile_cache_dir(env) == expect


def test_compile_cache_in_checkout():
    root = platform.DEFAULT_CACHE_DIR.parent
    assert (root / "gnss_sdr" / "__init__.py").exists()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_enable_compile_cache(monkeypatch):
    """CPU programs are not cached; on a GPU an unset directory becomes
    the fixed path, and a configured one is left alone."""
    assert platform.enable_compile_cache() is None          # cpu
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "/set/elsewhere")
        assert platform.enable_compile_cache() == "/set/elsewhere"
        jax.config.update("jax_compilation_cache_dir", None)
        assert platform.enable_compile_cache() == platform.compile_cache_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_chip_smoke_refuses_cpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU,
    and outside a checkout of the repository."""
    import pathlib
    import shutil
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    for cwd in (script.parent, tmp_path):
        if cwd == tmp_path:
            shutil.copy(script, tmp_path / "chip_smoke.py")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_compiled_step_matches_reference_on_card(gpu):
    """The Triton-compiled step (no interpreter) against the reference,
    on the card."""
    sc = _scene(n_ch=8, t_epochs=40)
    ref = trk.track_block(sc["params"], sc["rows"], sc["state"],
                          sc["sre"][:sc["buf"]], sc["sim"][:sc["buf"]],
                          sc["t"])
    got = fr.block_step(sc["sre"], sc["sim"], sc["rows"], sc["state"], 0,
                        params=sc["params"], t_epochs=sc["t"],
                        buf_len=sc["buf"])
    _assert_agree(sc, ref, got)
