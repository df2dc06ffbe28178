"""GPS L1 C/A PRN code generation (Gold codes).

Replacement for the reference's precomputed literal table
(reference: src/constants/gps_ca_constants.rs:1, 1346 LoC of literals) and
its legacy LFSR generator (reference: src/bk/gps_ca_prn.rs:28-59). Codes
are generated once at init in NumPy and live on device as a single
``[n_prn, 1023]`` int8 array — a batch dimension, not 32 separate vectors.

Generator structure (IS-GPS-200, public ICD):
  G1: 10-stage LFSR, feedback x^10 + x^3 + 1, output stage 10.
  G2: 10-stage LFSR, feedback x^10+x^9+x^8+x^6+x^3+x^2+1, output delayed
      per-PRN by a code-phase offset.
  chip_i = G1_i XOR G2_{(i - delay) mod 1023}, mapped to +/-1 as 2*b - 1.
"""
from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023

# Per-PRN G2 code-phase delays (chips), IS-GPS-200 table 3-I. PRNs 1-32 are
# GPS; PRNs 120-138 (index 33+) are SBAS (WAAS/EGNOS), matching the
# reference's extended table (src/bk/gps_ca_prn.rs:30-35).
G2_DELAY_CHIPS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
    469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
    # SBAS PRN 120..138
    145, 175, 52, 21, 237, 235, 886, 657, 634, 762, 355, 1012, 176, 603,
    130, 359, 595, 68, 386,
)


def _lfsr_sequence(taps: tuple[int, ...]) -> np.ndarray:
    """Run a 10-stage LFSR (all-ones seed) for 1023 chips.

    ``taps`` are 1-indexed stage numbers feeding the XOR that re-enters at
    stage 1; the output is stage 10. Returns a uint8 bit sequence.
    """
    state = np.ones(10, dtype=np.uint8)
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = state[9]
        fb = 0
        for t in taps:
            fb ^= state[t - 1]
        state[1:] = state[:-1]
        state[0] = fb
    return out


def _g2_delay_for_prn(prn: int) -> int:
    if 1 <= prn <= 32:
        return G2_DELAY_CHIPS[prn - 1]
    if 120 <= prn <= 138:
        return G2_DELAY_CHIPS[prn - 88]
    raise ValueError(f"invalid GPS/SBAS PRN: {prn}")


@functools.lru_cache(maxsize=None)
def generate_code(prn: int) -> np.ndarray:
    """1023-chip C/A code for one PRN as int8 in {-1, +1}."""
    g1 = _lfsr_sequence((10, 3))
    g2 = _lfsr_sequence((10, 9, 8, 6, 3, 2))
    g2 = np.roll(g2, _g2_delay_for_prn(prn))
    return (2 * (g1 ^ g2).astype(np.int8) - 1)


@functools.lru_cache(maxsize=None)
def code_table(n_prn: int = 32) -> np.ndarray:
    """``[n_prn, 1023]`` int8 table for PRNs 1..n_prn (batched device input)."""
    return np.stack([generate_code(p) for p in range(1, n_prn + 1)])


def first_chips_octal(prn: int, n: int = 10) -> int:
    """First ``n`` chips as the ICD's octal check value (test helper)."""
    bits = (generate_code(prn)[:n] + 1) // 2
    return int("".join(str(int(b)) for b in bits), 2)


def sample_code(prn: int, code_rate_hz: float, fs_hz: float) -> np.ndarray:
    """Resample the 1023-chip code to ``fs`` (nearest-chip / floor indexing).

    Matches the reference's host-side sampler semantics
    (src/utilities/ca_code.rs:12-27): n = round(fs / (rate/1023)) samples,
    chip index floor(i * rate / fs). Used for acquisition replicas and
    synthetic signals; the tracking path samples codes on device instead.
    """
    n = int(round(fs_hz / (code_rate_hz / CODE_LENGTH)))
    idx = np.floor(np.arange(n, dtype=np.float64) * code_rate_hz / fs_hz)
    idx = idx.astype(np.int64) % CODE_LENGTH
    return generate_code(prn)[idx]
