"""Agreement rules between the block tracking step and its reference.

The step (ops/pallas/track_step.py) runs the epoch arithmetic of
``receiver.tracking.track_block`` with the ``slice`` correlator, op for
op. What can differ is summation order (the six correlator sums, and
XLA's or Triton's sin/cos), so:

  * integer bookkeeping and flags agree EXACTLY: processed, locked,
    lost events, epoch starts and indices, and the active / PRN /
    offset / epoch / lost-count / integer-chip ledger;
  * the correlator sums agree to ``SUM_RTOL`` of the field's largest
    magnitude (f32 sums of ~2k-33k products in another order);
  * the loop outputs agree to ``CARR_FREQ_ATOL_HZ`` (carrier NCO),
    ``CODE_RATE_RTOL`` (code NCO) and ``CHIP_PHASE_ATOL`` chips (code
    phase at each epoch start, modulo the code length). A sum-order
    difference moves the loop filters by far less: these bounds hold a
    tracking loop that locked on the same signal, over a 500-epoch block.

Rarely, a sum-order difference rounds a loop filter's f32 output to the
neighbouring value (0.0625 Hz for a 1.023 MHz code rate). If a replica
start then crosses a sample boundary in one version only, that epoch's
sums differ by up to 1/(samples per chip) of their size and the loops
part for a few epochs; such a run fails these rules. On a loop driven
by noise alone the two random-walk apart and no float bound holds.

Telemetry of epochs a channel did not process is not compared beyond
its flags: the reference reports sums over a clamped window there.
"""
from __future__ import annotations

import numpy as np

EXACT_TELEM = ("processed", "locked", "lost_event", "start_offset",
               "epoch_index")
EXACT_STATE = ("active", "prn_idx", "offset", "epochs", "lost_count",
               "chip_int")
SUMS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
SUM_RTOL = 1e-3
CARR_FREQ_ATOL_HZ = 0.05
CODE_RATE_RTOL = 1e-6
CHIP_PHASE_ATOL = 1e-3


def _wrap(d, period):
    return np.abs((d + 0.5 * period) % period - 0.5 * period)


def track_mismatches(ref, got, code_length: int) -> dict:
    """Compare two ``(ChannelState, EpochTelemetry)`` results. Returns
    ``{check: worst value}`` for every check that fails (empty = the
    two agree), so a caller can print what broke."""
    (rs, rt), (gs, gt) = ref, got
    bad = {}
    for f in EXACT_STATE:
        if not np.array_equal(np.asarray(getattr(rs, f)),
                              np.asarray(getattr(gs, f))):
            bad[f"state.{f}"] = "differs"
    for f in EXACT_TELEM:
        if not np.array_equal(np.asarray(getattr(rt, f)),
                              np.asarray(getattr(gt, f))):
            bad[f"telem.{f}"] = "differs"
    proc = np.asarray(rt.processed)
    if not proc.any():
        return bad
    for f in SUMS:
        a = np.asarray(getattr(rt, f), np.float64)[proc]
        b = np.asarray(getattr(gt, f), np.float64)[proc]
        err = float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))
        if err > SUM_RTOL:
            bad[f"telem.{f}"] = err
    for f, scale in (("carr_freq", None), ("code_rate", CODE_RATE_RTOL)):
        for where, a, b in (
                ("telem", np.asarray(getattr(rt, f))[proc],
                 np.asarray(getattr(gt, f))[proc]),
                ("state", np.asarray(getattr(rs, f)),
                 np.asarray(getattr(gs, f)))):
            a = a.astype(np.float64)
            b = b.astype(np.float64)
            err = float(np.abs(a - b).max()) if a.size else 0.0
            lim = (CARR_FREQ_ATOL_HZ if scale is None
                   else scale * max(1.0, float(np.abs(a).max())))
            if err > lim:
                bad[f"{where}.{f}"] = err
    cp = _wrap(np.asarray(rt.chip_phase, np.float64)[proc]
               - np.asarray(gt.chip_phase, np.float64)[proc], code_length)
    if cp.max() > CHIP_PHASE_ATOL:
        bad["telem.chip_phase"] = float(cp.max())
    return bad


def max_errors(ref, got, code_length: int) -> dict:
    """Largest observed difference per compared float field (for the
    record; the pass/fail rule is ``track_mismatches``)."""
    (_, rt), (_, gt) = ref, got
    proc = np.asarray(rt.processed)
    out = {}
    for f in SUMS + ("carr_freq", "code_rate"):
        a = np.asarray(getattr(rt, f), np.float64)[proc]
        b = np.asarray(getattr(gt, f), np.float64)[proc]
        out[f] = float(np.abs(a - b).max()) if a.size else 0.0
    cp = _wrap(np.asarray(rt.chip_phase, np.float64)[proc]
               - np.asarray(gt.chip_phase, np.float64)[proc], code_length)
    out["chip_phase"] = float(cp.max()) if cp.size else 0.0
    return out
