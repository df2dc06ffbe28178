"""Batched PCPS (parallel code phase search) acquisition.

Re-design of the reference's acquisition engine
(reference: src/acquisition/do_acquisition.rs:158-238). The reference runs
32 rayon workers, each looping serially over 29 Doppler bins and 10
non-coherent integrations, calling scalar-SIMD FFTs. Here the whole
PRN x Doppler x integration cube is one jitted XLA graph:

    power[p, d, n] = sum_c | ifft( fft(x_c * e^{-j2pi f_d i/fs})
                                   * conj(CODE_FFT_p) ) |^2

with a ``lax.scan`` over the non-coherent integration axis to bound peak
memory at [P, D, N] while the FFT batch stays large (P*D transforms per
step) to saturate the chip.

Detection matches the reference detector: peak power / average power of
the best Doppler bin (peak excluded) > threshold
(reference do_acquisition.rs:229-238).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.constellation import SignalSpec
from . import nco

# float32 dots where the CPU reference needs float32 (a GPU may run an
# f32 dot in TF32); the conv engine's bf16 matched filter is explicit
_F32 = jax.lax.Precision.HIGHEST


class AcqResults(NamedTuple):
    """Structure-of-arrays acquisition verdict over the PRN batch.

    Field semantics follow the reference's ``AcquisitionResult``
    (src/acquisition/do_acquisition.rs:94-102); ``carrier_freq_hz``
    includes the IF, as in the reference (its DopplerShiftTable stores
    f_if + doppler, src/acquisition/doppler_shift.rs:13-22).
    """

    detected: jax.Array          # [P] bool, ratio > threshold
    ratio: jax.Array             # [P] f32 peak/avg detection statistic
    peak_power: jax.Array        # [P] f32
    code_phase_samples: jax.Array  # [P] i32 lag of the peak
    carrier_freq_hz: jax.Array   # [P] f32, f_if + doppler of best bin
    power: jax.Array | None = None  # [P, D, N] full cube (debug/fine search)


def doppler_grid(span_hz: float, step_hz: float) -> np.ndarray:
    """Symmetric Doppler grid, reference semantics
    (do_acquisition.rs:248-262): span/step + 1 bins from -span/2."""
    n = int(span_hz / step_hz) + 1
    return (-span_hz / 2.0 + np.arange(n) * step_hz).astype(np.float32)


def code_replica_ffts(spec: SignalSpec, fs_hz: float, n_prn: int) -> jax.Array:
    """[P, N] conj-ready FFTs of the sampled code replicas (precomputed
    once, reference does this per worker at do_acquisition.rs:133-138)."""
    reps = np.stack(
        [spec.sample_code(p, spec.code_rate_hz, fs_hz) for p in range(1, n_prn + 1)]
    ).astype(np.float32)
    return jnp.asarray(np.fft.fft(reps, axis=-1).astype(np.complex64))


def pcps_power(
    samples: jax.Array,        # [n_int * N] complex64
    code_ffts: jax.Array,      # [P, N] complex64
    carrier_freqs: jax.Array,  # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    coherent: int = 1,         # code periods summed coherently per group
    bit_edge_hypotheses: int = 1,  # group-start offsets tried (max-combined)
    sample_offset=0,           # traced/int: global index of samples[0],
                               # so time-sharded chunks keep exact phase
) -> jax.Array:
    """Integrated correlation power cube [P, D, N].

    ``coherent=k`` sums k consecutive 1-period correlations as complex
    values before squaring (the remaining n_int/k groups add
    non-coherently). Coherent gain multiplies the peak/avg detection
    statistic by ~k instead of ~1 (weak-satellite sensitivity; the
    reference capture's PRNs 9/28 need it, config.txt note [2]).
    Caveats: residual Doppler must stay well under 1/(k * T_code) —
    narrow the Doppler grid step accordingly — and data-bit edges
    inside a group cancel (choose k <= bit period / code period).

    ``bit_edge_hypotheses=H > 1`` defends the coherent sum against
    unknown data-bit edges: the k-period grouping is re-anchored at H
    start offsets spread over one coherent length, each hypothesis
    integrates the same number of groups, and the cubes combine with an
    elementwise max — whichever offset puts the bit flip at a group
    boundary keeps full coherent gain. The per-period FFT correlations
    are shared across hypotheses, so the extra cost is only the group
    combine + IFFT stage (H x). Use H=k to try every offset.

    Phase continuity across periods is free: the Doppler mix rides one
    exact uint32 NCO ramp over the whole chunk.

    Traceable core shared by the single-chip search and the sharded
    variants in gnss_sdr.parallel (time shards psum these cubes).
    """
    n_fft = code_ffts.shape[-1]
    n_prn = code_ffts.shape[0]
    if n_int % coherent:
        raise ValueError(f"n_int={n_int} not divisible by coherent={coherent}")

    # Exact linear phase via uint32 NCO (see ops/nco.py); the reference
    # precomputes f32 cos/-sin tables per bin (doppler_shift.rs:11-22).
    step = nco.freq_to_step(carrier_freqs, fs_hz)          # [D] u32
    acc0 = jnp.asarray(sample_offset, jnp.uint32) * step
    phase = nco.phase_ramp(acc0, step, n_int * n_fft)       # [D, L] u32
    c, s = nco.cis(phase)
    lo = jax.lax.complex(c, -s)                             # e^{-j theta}
    shifted = (samples[None, :] * lo).reshape(-1, n_int, n_fft)
    spectra = jnp.fft.fft(shifted, axis=-1)                 # [D, n_int, N]

    conj_codes = jnp.conj(code_ffts)                        # [P, N]
    d = spectra.shape[0]

    def accumulate(acc, spec_sum):
        prod = spec_sum[None, :, :] * conj_codes[:, None, :]  # [P, D, N]
        corr = jnp.fft.ifft(prod, axis=-1)
        return acc + jnp.abs(corr) ** 2, None

    power0 = jnp.zeros((n_prn, d, n_fft), jnp.float32)

    if bit_edge_hypotheses <= 1 or coherent <= 1:
        n_groups = n_int // coherent
        # FFT linearity: sum_j ifft(X_j * C*) == ifft((sum_j X_j) * C*),
        # so the coherent combine is one [D, N] spectrum sum per group
        # instead of k multiplies + k IFFTs of the [P, D, N] cube
        grouped = jnp.moveaxis(
            spectra.reshape(d, n_groups, coherent, n_fft).sum(axis=2), 1, 0
        )                                                   # [G, D, N]
        power, _ = jax.lax.scan(accumulate, power0, grouped)
        return power                                        # [P, D, N]

    # bit-edge hypothesis search: re-anchor the k-period groups at H
    # offsets; every hypothesis integrates the same g_min groups so the
    # cubes are scale-identical and combine with an elementwise max
    k = coherent
    h_n = min(bit_edge_hypotheses, k)
    offsets = sorted({(j * k) // h_n for j in range(h_n)})
    g_min = min((n_int - h) // k for h in offsets)
    if g_min < 1:
        raise ValueError(
            f"n_int={n_int} too short for coherent={k} with "
            f"bit-edge offsets up to {offsets[-1]}"
        )

    def hypothesis_cube(h: int) -> jax.Array:
        grouped = jnp.moveaxis(
            spectra[:, h:h + g_min * k].reshape(
                d, g_min, k, n_fft
            ).sum(axis=2),
            1, 0,
        )                                                   # [G, D, N]
        power, _ = jax.lax.scan(accumulate, power0, grouped)
        return power

    best = hypothesis_cube(offsets[0])
    for h in offsets[1:]:
        best = jnp.maximum(best, hypothesis_cube(h))
    return best


def coherent_group_count(n_int: int, coherent: int,
                         bit_edge_hypotheses: int = 1) -> int:
    """Number of non-coherent groups the power cube integrates —
    n_int/coherent for the plain path, the per-hypothesis g_min for the
    bit-edge path (must mirror pcps_power's grouping exactly)."""
    if bit_edge_hypotheses <= 1 or coherent <= 1:
        return max(1, n_int // max(1, coherent))
    k = coherent
    h_n = min(bit_edge_hypotheses, k)
    offsets = sorted({(j * k) // h_n for j in range(h_n)})
    return min((n_int - h) // k for h in offsets)


def _gamma_sf(n: int, x: float) -> float:
    """Survival function Q(n, x) of Gamma(n, 1) for integer n:
    e^{-x} * sum_{i<n} x^i / i!, evaluated in log space."""
    if x <= 0.0:
        return 1.0
    import math

    terms = [-x + i * math.log(x) - math.lgamma(i + 1) for i in range(n)]
    m = max(terms)
    return math.exp(m) * sum(math.exp(t - m) for t in terms)


def _max_ratio_median(n_groups: int, n_cells: float) -> float:
    """Median of the peak/avg statistic of a noise-only power cube:
    cells are iid Gamma(n_groups) (sum of n_groups |CN(0,1)|^2 group
    powers), the cube mean concentrates at n_groups, and the max of
    n_cells draws has median r where n_cells * Q(n_groups, n_groups*r)
    = ln 2. Solved by bisection."""
    import math

    target = math.log(2.0) / max(n_cells, 1.0)
    lo, hi = 1.0, 400.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _gamma_sf(n_groups, n_groups * mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def peak_avg_threshold(
    t_ref: float,
    *,
    n_groups: int,
    n_cells: float,
    hypotheses: int = 1,
    ref_groups: int = 10,
    ref_cells: float = 29.0 * 2046.0,
) -> float:
    """Scale the reference peak/avg threshold to an arbitrary
    integration mode.

    The reference's 7.0 is calibrated for 10 x 1 ms non-coherent
    integration (do_acquisition.rs:237,23). Fewer non-coherent groups
    (coherent integration) make the noise-only peak/avg floor rise
    (heavier-tailed Gamma cells), so a fixed 7.0 false-alarms — the
    scaled threshold preserves the *margin over the noise floor
    median* instead: t_ref / floor(ref mode) = t_eff / floor(actual
    mode). Bit-edge hypotheses multiply the effective cell count
    (max-combine of H cubes)."""
    margin = t_ref / _max_ratio_median(ref_groups, ref_cells)
    return margin * _max_ratio_median(n_groups, n_cells * max(1, hypotheses))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pcps_power_padded(
    samples: jax.Array,        # [(n_int + 1) * N] complex64
    code_fft_padded: jax.Array,  # [P, M] complex64, M = next_pow2(2N)
    carrier_freqs: jax.Array,  # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    n_fft: int,
    coherent: int = 1,
    sample_offset=0,
) -> jax.Array:
    """Power cube via power-of-two FFTs (FFT libraries favor pow2 sizes;
    one code period is typically not one, e.g. 16368).
    ``coherent`` groups combine as in pcps_power (spectrum-sum).

    Each integration correlates a TWO-period data block against the
    zero-padded code with M = next_pow2(2N)-point transforms; lags
    0..N-1 are then exact LINEAR correlations (no wrap), covering every
    code phase. Needs one extra code period of trailing samples.
    Detection statistics differ slightly from the circular variant
    (noise does not wrap) but peak locations are identical.
    """
    m = code_fft_padded.shape[-1]
    n_prn = code_fft_padded.shape[0]

    step = nco.freq_to_step(carrier_freqs, fs_hz)
    acc0 = jnp.asarray(sample_offset, jnp.uint32) * step
    phase = nco.phase_ramp(acc0, step, samples.shape[-1])
    c, s = nco.cis(phase)
    lo = jax.lax.complex(c, -s)
    shifted = samples[None, :] * lo                       # [D, L+N]

    conj_codes = jnp.conj(code_fft_padded)                # [P, M]

    if n_int % coherent:
        raise ValueError(f"n_int={n_int} not divisible by coherent={coherent}")

    def accumulate(acc, g_idx):
        # coherent spectrum sum over the group's code periods
        spec = jnp.zeros((shifted.shape[0], m), jnp.complex64)
        for j in range(coherent):
            block = jax.lax.dynamic_slice_in_dim(
                shifted, (g_idx * coherent + j) * n_fft, 2 * n_fft, axis=1
            )                                              # [D, 2N]
            spec = spec + jnp.fft.fft(block, n=m, axis=-1)
        prod = spec[None, :, :] * conj_codes[:, None, :]   # [P, D, M]
        corr = jnp.fft.ifft(prod, axis=-1)[..., :n_fft]    # [P, D, N]
        return acc + jnp.abs(corr) ** 2, None

    power0 = jnp.zeros(
        (n_prn, carrier_freqs.shape[0], n_fft), jnp.float32
    )
    power, _ = jax.lax.scan(
        accumulate, power0, jnp.arange(n_int // coherent, dtype=jnp.int32)
    )
    return power


def code_replica_ffts_padded(
    spec: SignalSpec, fs_hz: float, n_prn: int
) -> jax.Array:
    """[P, M] padded-code FFTs for the pow2 PCPS path."""
    n = spec.samples_per_code(fs_hz)
    m = _next_pow2(2 * n)
    reps = np.zeros((n_prn, m), np.float32)
    for p in range(1, n_prn + 1):
        reps[p - 1, :n] = spec.sample_code(p, spec.code_rate_hz, fs_hz)
    return jnp.asarray(np.fft.fft(reps, axis=-1).astype(np.complex64))


def pcps_power_conv(
    samples_re: jax.Array,     # [(n_int + 1) * N] f32
    samples_im: jax.Array,     # [(n_int + 1) * N] f32
    codes: jax.Array,          # [P, N] f32 +/-1 sampled replicas
    carrier_freqs: jax.Array,  # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    sample_offset=0,
    seg_width: int = 128,
) -> jax.Array:
    """FFT-free PCPS power cube [P, D, N] via convolution.

    The matched filter IS a correlation: one conv_general_dilated with
    PRN replicas as output channels and (Doppler x integration) as the
    batch computes every lag of every PRN — 2*B*P*N^2 MACs on the
    matrix units. It uses only conv, matmul and f32 elementwise ops (no
    jnp.fft, no complex dtype), which is what lets it run inside the
    span program (Receiver.run scan_blocks); ``engine="auto"`` is the
    FFT engine.

    The N-tap filter is split into ``n_seg = ceil(N / seg_width)``
    segments presented to XLA as input channels (filter [P, n_seg,
    seg_width] over blocks [B, n_seg, N + seg_width - 1]) — identical
    math (zero-padded taps contribute nothing), but the short-filter
    multi-channel shape maps onto matrix units, where a single-channel
    N-tap filter does not.

    bf16 inputs, f32 accumulation (stated, not a TF32 accident): matrix
    units run bf16 at a multiple of their f32 rate and the detection
    statistic is a peak/avg RATIO over
    N-point sums — a ~3-decimal-digit mantissa per product is far
    inside the noise floor of the post-correlation SNR at any
    detectable C/N0.

    Linear correlation over two-period blocks (like pcps_power_padded):
    needs one extra code period of trailing samples; lags 0..N-1 exact.
    """
    n_fft = codes.shape[-1]
    n_prn = codes.shape[0]
    d = carrier_freqs.shape[0]
    length = (n_int + 1) * n_fft

    step = nco.freq_to_step(carrier_freqs, fs_hz)
    acc0 = jnp.asarray(sample_offset, jnp.uint32) * step
    phase = nco.phase_ramp(acc0, step, length)              # [D, L+N]
    c, s = nco.cis(phase)
    # planar mix: (I + jQ) e^{-j t} without complex dtype
    xre = samples_re[None, :length] * c + samples_im[None, :length] * s
    xim = samples_im[None, :length] * c - samples_re[None, :length] * s

    n_seg = -(-n_fft // seg_width)
    npad = n_seg * seg_width
    pad = npad - n_fft
    if pad:
        z = jnp.zeros((d, pad), xre.dtype)
        xre = jnp.concatenate([xre, z], axis=1)
        xim = jnp.concatenate([xim, z], axis=1)
    filt = jnp.pad(codes, ((0, 0), (0, pad))).reshape(
        n_prn, n_seg, seg_width).astype(jnp.bfloat16)

    win = n_fft + seg_width - 1

    def blocks(m):
        # [D, L(+pad)] -> [D * n_int, n_seg, N + S - 1]: row (k, j)
        # holds m[kN + Sj : kN + Sj + N + S - 1], so a VALID conv with
        # the S-tap segment j sums code[S*j + m'] * x[kN + l + S*j + m']
        # over m' — summed over j (input channels) this is the full
        # N-tap correlation at lags l = 0..N-1.
        rows = []
        for k in range(n_int):
            segs = [
                jax.lax.dynamic_slice_in_dim(
                    m, k * n_fft + seg_width * j, win, axis=1)
                for j in range(n_seg)
            ]
            rows.append(jnp.stack(segs, axis=1))
        return jnp.stack(rows, axis=1).reshape(
            d * n_int, n_seg, win).astype(jnp.bfloat16)

    def correlate(x):
        return jax.lax.conv_general_dilated(
            x, filt, window_strides=(1,), padding="VALID",
            preferred_element_type=jnp.float32,
        )                                                    # [B, P, N]

    cr = correlate(blocks(xre)).reshape(d, n_int, n_prn, n_fft)
    ci = correlate(blocks(xim)).reshape(d, n_int, n_prn, n_fft)
    power = (cr * cr + ci * ci).sum(axis=1)                  # [D, P, N]
    return jnp.moveaxis(power, 0, 1)                         # [P, D, N]


def decimate_mean(samples_re: jax.Array, samples_im: jax.Array, r: int):
    """Boxcar (integrate-and-dump) decimation by ``r`` of planar IQ.

    The coarse acquisition front end: averaging r consecutive samples
    is a crude but adequate anti-alias filter for a search at ~1
    sample/chip (the code mainlobe is preserved; worst-case scalloping
    loss at 1 sample/chip is ~2-3 dB, recovered by the full-rate
    refinement stage)."""
    if r == 1:
        return samples_re, samples_im
    n = (samples_re.shape[-1] // r) * r
    re = samples_re[..., :n].reshape(-1, r).mean(axis=-1)
    im = samples_im[..., :n].reshape(-1, r).mean(axis=-1)
    return re, im


def refine_lags(
    samples_re: jax.Array,     # [(n_int + 1) * N] f32, full rate
    samples_im: jax.Array,
    codes: jax.Array,          # [P, N] f32 full-rate replicas
    coarse_lags: jax.Array,    # [P] i32 full-rate lag estimates
    carrier_freqs: jax.Array,  # [P] f32 per-PRN carrier (f_if + doppler)
    *,
    fs_hz: float,
    n_int: int,
    half_width: int,
) -> tuple[jax.Array, jax.Array]:
    """Full-rate code-phase refinement around coarse lag estimates.

    Stage 2 of the coarse-to-fine search: the decimated stage 1 locates
    the peak to +- half a coarse sample; this evaluates the full-rate
    correlation at the ``2 * half_width + 1`` lags around each coarse
    estimate (tiny: P * n_int * W * N MACs) and returns the refined
    integer lags [P] plus the refined peak power [P].

    Gather-free / argmax-free: windows come from
    vmapped dynamic slices, the peak via max + mask-weighted iota.
    """
    n_fft = codes.shape[-1]
    w = 2 * half_width + 1
    tail = jnp.zeros((w,), samples_re.dtype)
    xre = jnp.concatenate([samples_re, tail])
    xim = jnp.concatenate([samples_im, tail])

    step = nco.freq_to_step(carrier_freqs, fs_hz)           # [P]
    phase = nco.phase_ramp(jnp.zeros_like(step), step, xre.shape[-1])
    c, s = nco.cis(phase)
    mre = xre[None, :] * c + xim[None, :] * s               # [P, L]
    mim = xim[None, :] * c - xre[None, :] * s

    # window start lag may go negative by up to half_width; the code is
    # periodic, so wrap it into [0, n_fft) instead (select-wrap — no
    # integer mod on the restricted backend). Window k then starts at
    # k*n_fft + l0 <= n_int*n_fft - 1, and the w-zero tail only shaves
    # <= w trailing samples off the last window of boundary lags
    # (~w / (n_int * n_fft) relative power error, well under the
    # detection margin).
    lag0 = coarse_lags - half_width
    lag0 = jnp.where(lag0 < 0, lag0 + n_fft, lag0)
    win = n_fft + w - 1

    def windows(m):
        def one(row, l0):
            return jnp.stack([
                jax.lax.dynamic_slice(
                    row, (jnp.int32(k * n_fft) + l0,), (win,))
                for k in range(n_int)
            ])
        return jax.vmap(one)(m, lag0)                        # [P, K, win]

    wre = windows(mre)
    wim = windows(mim)
    # W shifted dot products; W is small so unrolled slices beat
    # materializing a [P, K, W, N] cube
    powers = []
    for v in range(w):
        cr = jnp.einsum("pkn,pn->pk", wre[..., v:v + n_fft], codes,
                        precision=_F32)
        ci = jnp.einsum("pkn,pn->pk", wim[..., v:v + n_fft], codes,
                        precision=_F32)
        powers.append((cr * cr + ci * ci).sum(axis=1))
    power = jnp.stack(powers, axis=1)                        # [P, W]
    peak = power.max(axis=-1)
    mask = (power == peak[:, None]).astype(jnp.float32)
    mask = mask / jnp.maximum(mask.sum(-1, keepdims=True), 1.0)
    iota = jax.lax.broadcasted_iota(jnp.float32, (1, w), 1)
    off = (mask * iota).sum(-1).astype(jnp.int32)
    lags = lag0 + off
    lags = jnp.where(lags < 0, lags + n_fft, lags)
    lags = jnp.where(lags >= n_fft, lags - n_fft, lags)
    return lags, peak


def detect_real(
    power: jax.Array,          # [P, D, N]
    carrier_freqs: jax.Array,  # [D]
    threshold: float,
) -> AcqResults:
    """Detector built only from max/compare/dot (no argmax/gather —
    restricted-backend companion of detect())."""
    n_fft = power.shape[-1]
    # best Doppler bin per PRN
    peak_per_bin = power.max(axis=-1)                        # [P, D]
    bin_peak = peak_per_bin.max(axis=-1, keepdims=True)      # [P, 1]
    bin_mask = (peak_per_bin == bin_peak).astype(jnp.float32)
    bin_mask = bin_mask / jnp.maximum(bin_mask.sum(-1, keepdims=True), 1.0)
    # soft-select the best bin's power row: [P, N]
    bin_power = jnp.einsum("pdn,pd->pn", power, bin_mask, precision=_F32)
    peak = bin_power.max(axis=-1)
    lag_iota = jax.lax.broadcasted_iota(jnp.float32, (1, n_fft), 1)
    lag_mask = (bin_power == peak[:, None]).astype(jnp.float32)
    lag_mask = lag_mask / jnp.maximum(lag_mask.sum(-1, keepdims=True), 1.0)
    code_phase = (lag_mask * lag_iota).sum(-1).astype(jnp.int32)
    # full f32: TF32 would round the Doppler by several Hz
    freq = jnp.einsum("d,pd->p", carrier_freqs, bin_mask, precision=_F32)
    avg = (jnp.sum(bin_power, axis=-1) - peak) / jnp.float32(n_fft - 1)
    ratio = peak / jnp.maximum(avg, jnp.float32(1e-20))
    return AcqResults(
        detected=ratio > jnp.float32(threshold),
        ratio=ratio,
        peak_power=peak,
        code_phase_samples=code_phase,
        carrier_freq_hz=freq,
    )


@functools.partial(
    jax.jit, static_argnames=("fs_hz", "n_int", "threshold", "seg_width")
)
def pcps_search_conv(
    samples_re: jax.Array,
    samples_im: jax.Array,
    codes: jax.Array,
    carrier_freqs: jax.Array,
    *,
    fs_hz: float,
    n_int: int,
    threshold: float = 7.0,
    seg_width: int = 128,
) -> AcqResults:
    """Complete FFT-free, gather-free, complex-free PCPS search."""
    power = pcps_power_conv(
        samples_re, samples_im, codes, carrier_freqs,
        fs_hz=fs_hz, n_int=n_int, seg_width=seg_width,
    )
    return detect_real(power, carrier_freqs, threshold)


@functools.partial(
    jax.jit,
    static_argnames=(
        "fs_hz", "n_int", "decim", "threshold", "seg_width",
        "fine", "fine_window_hz", "fine_steps", "fine_squaring",
        "fine_n_sub",
    ),
)
def acquire_conv(
    samples_re: jax.Array,     # [(n_int + 1) * N] f32, full rate
    samples_im: jax.Array,
    codes: jax.Array,          # [P, N] f32 full-rate replicas
    codes_coarse: jax.Array,   # [P, N / decim] f32 boxcar-decimated
    sel: jax.Array,            # [B, P] f32 row-selection matrix
    carrier_freqs: jax.Array,  # [D] f32 = f_if + doppler grid
    *,
    fs_hz: float,
    n_int: int,
    decim: int,
    threshold: float,
    seg_width: int = 128,
    fine: bool = True,
    fine_window_hz: float = 500.0,
    fine_steps: int = 129,
    fine_squaring: bool = False,
    fine_n_sub: int = 1,
) -> AcqResults:
    """Whole acquisition — coarse search, full-rate lag refinement, fine
    Doppler — as ONE jitted dispatch.

    Three design rules:

    * everything is an argument (a closure-captured constant is
      embedded in the compiled program; arguments are not),
    * one dispatch per search (each jitted call pays a host round
      trip; fusing search + refine + fine Doppler collapses three),
    * PRN bucketing by selection matmul: ``sel @ codes`` subsets the
      replica batch to the scheduler's untracked candidates on-device
      (a [B, P] one-hot matmul), so steady-state searches pay for B
      rows, not n_prn.

    Stage 1 searches boxcar-decimated samples against boxcar-decimated
    replicas — conv MACs scale as N^2, so decim=r cuts the dominant
    cost r^2x. Stage 2 (decim > 1) re-evaluates the full-rate
    correlation on the +-decim lags around each coarse peak. The
    detection ratio is the coarse-stage statistic (peak/avg over the
    decimated cube); peak_power and code_phase_samples are full-rate
    refined. Reference detector semantics: do_acquisition.rs:229-238.
    """
    codes_b = jnp.matmul(sel, codes, precision=_F32)        # [B, N]
    if decim > 1:
        codes_cb = jnp.matmul(sel, codes_coarse, precision=_F32)
        red, imd = decimate_mean(samples_re, samples_im, decim)
    else:
        codes_cb = codes_b
        red, imd = samples_re, samples_im
    power = pcps_power_conv(
        red, imd, codes_cb, carrier_freqs,
        fs_hz=fs_hz / decim, n_int=n_int, seg_width=seg_width,
    )
    res = detect_real(power, carrier_freqs, threshold)
    if decim > 1:
        lags, peak = refine_lags(
            samples_re, samples_im, codes_b,
            res.code_phase_samples * decim, res.carrier_freq_hz,
            fs_hz=fs_hz, n_int=n_int, half_width=decim,
        )
        res = res._replace(code_phase_samples=lags, peak_power=peak)
    if fine:
        freqs = fine_doppler_conv(
            samples_re, samples_im, codes_b,
            res.code_phase_samples, res.carrier_freq_hz,
            fs_hz=fs_hz, n_int=n_int,
            window_hz=fine_window_hz, n_steps=fine_steps,
            squaring=fine_squaring, n_sub=fine_n_sub,
        )
        res = res._replace(carrier_freq_hz=freqs)
    return res


def fine_doppler_conv(
    samples_re: jax.Array,     # [>= n_int * N] f32
    samples_im: jax.Array,
    code_samples: jax.Array,   # [P, N] f32 +/-1 sampled replicas
    code_phase: jax.Array,     # [P] i32 from the search
    coarse_freq: jax.Array,    # [P] f32 carrier (f_if + doppler) estimate
    *,
    fs_hz: float,
    n_int: int,
    window_hz: float = 500.0,
    n_steps: int = 129,
    squaring: bool = False,
    n_sub: int = 1,
) -> jax.Array:
    """FFT-free fine Doppler (companion of fine_doppler, which needs
    jnp.fft): the conv engine's refinement stage.

    Wipe the code at the acquired phase, collapse each code period to
    one complex prompt sum at the coarse carrier, then evaluate the
    residual-tone power on a dense +/- window_hz offset grid with one
    small matmul (an explicit DFT over n_int points) and pick the peak
    mask-wise (no argmax). Resolution window_hz * 2 / (n_steps - 1)
    (~7.8 Hz at the defaults) — well inside the Costas pull-in range.

    ``squaring=True`` squares the per-period sums first, wiping residual
    BPSK (secondary/NH codes, data bits); the tone then sits at twice
    the offset and the result is halved.

    ALIAS HAZARD (squaring): the squared per-period series is sampled at
    1/T_period, so offsets differing by k/(2*T_period) real Hz have
    EXACTLY equal line power — a grid spanning beyond that is a coin
    flip between the true tone and its alias (observed: Galileo
    E1B handoff landing 250 Hz off, one full cycle per 4 ms epoch,
    invisible to the Costas discriminator). ``n_sub > 1`` fixes this
    unambiguously: each code period is split into n_sub sub-segments
    (modulation is constant WITHIN a period for every supported signal
    — data/secondary flips sit on period boundaries), and the phase
    slope across within-period sub-segment pairs

        delta1 = angle(sum_{m,s} z[m,s+1] * conj(z[m,s])) / (2 pi T_sub)

    is modulation-free and unambiguous over +-n_sub/(2*T_period). The
    line search then runs on delta1-derotated period sums over a narrow
    alias-free span. ``n_sub`` must divide the period sample count.
    """
    n_fft = code_samples.shape[-1]
    length = n_int * n_fft
    p = code_samples.shape[0]
    two_pi = jnp.float32(2.0 * np.pi)
    use_xprod = squaring and n_sub > 1 and (n_fft % n_sub == 0)
    if use_xprod:
        t_sub = n_fft / n_sub / fs_hz
        # alias-free narrow span around the stage-1 estimate: the
        # doubled-domain alias spacing is 1000/T_period_ms Hz; stay
        # well inside it (stage-1 residual is a few Hz)
        alias_hz = fs_hz / n_fft          # doubled-domain alias spacing
        span = min(2.0 * window_hz, 0.45 * alias_hz)
    else:
        span = (2.0 * window_hz) if squaring else window_hz
    deltas = jnp.linspace(-span, span, n_steps).astype(jnp.float32)
    t_ms = (jnp.arange(n_int, dtype=jnp.float32) * n_fft
            / jnp.float32(fs_hz))                       # [M]
    ph = deltas[:, None] * t_ms[None, :] * two_pi
    dft_c = jnp.cos(ph)                                  # [K, M]
    dft_s = jnp.sin(ph)

    i = jnp.arange(length, dtype=jnp.float32)
    xre = samples_re[:length]
    xim = samples_im[:length]

    def one(code, cp, f0):
        rep = jnp.roll(code, cp)
        rep_long = jnp.tile(rep, n_int)
        theta = f0 / jnp.float32(fs_hz) * i
        theta = (theta - jnp.floor(theta)) * two_pi
        c = jnp.cos(theta)
        sn = jnp.sin(theta)
        wre = (xre * c + xim * sn) * rep_long
        wim = (xim * c - xre * sn) * rep_long
        delta1 = jnp.float32(0.0)
        if use_xprod:
            sre = wre.reshape(n_int, n_sub, n_fft // n_sub).sum(-1)
            sim = wim.reshape(n_int, n_sub, n_fft // n_sub).sum(-1)
            # within-period sub-segment cross products (data-free)
            xr = (sre[:, 1:] * sre[:, :-1]
                  + sim[:, 1:] * sim[:, :-1]).sum()
            xi = (sim[:, 1:] * sre[:, :-1]
                  - sre[:, 1:] * sim[:, :-1]).sum()
            delta1 = jnp.arctan2(xi, xr) / (two_pi * jnp.float32(t_sub))
            # derotate sub-segments by delta1, re-sum into period sums
            ts = (jnp.arange(n_int, dtype=jnp.float32)[:, None] * n_fft
                  + jnp.arange(n_sub, dtype=jnp.float32)[None, :]
                  * (n_fft // n_sub)) / jnp.float32(fs_hz)   # [M, S]
            ang = two_pi * delta1 * ts
            dc, ds = jnp.cos(ang), jnp.sin(ang)
            zre = (sre * dc + sim * ds).sum(-1)          # [M]
            zim = (sim * dc - sre * ds).sum(-1)
        else:
            zre = wre.reshape(n_int, n_fft).sum(-1)      # [M]
            zim = wim.reshape(n_int, n_fft).sum(-1)
        if squaring:
            zre, zim = zre * zre - zim * zim, 2.0 * zre * zim
        # residual tone power at each offset: |sum_m z_m e^{-j ph}|^2
        def mv(a, b):
            return jnp.matmul(a, b, precision=_F32)
        pr = mv(dft_c, zre) + mv(dft_s, zim)             # [K]
        pi = mv(dft_c, zim) - mv(dft_s, zre)
        pow_k = pr * pr + pi * pi
        peak = pow_k.max()
        m = (pow_k == peak).astype(jnp.float32)
        m = m / jnp.maximum(m.sum(), 1.0)
        d_star = (m * deltas).sum()
        return f0 + delta1 + (d_star * 0.5 if squaring else d_star)

    return jax.vmap(one)(code_samples[:p], code_phase, coarse_freq)


def detect(
    power: jax.Array,          # [P, D, N]
    carrier_freqs: jax.Array,  # [D]
    threshold: float,
    return_power: bool = False,
    mode: str = "peak_avg",
    exclusion_samples: int = 0,
) -> AcqResults:
    """Detector over the power cube. Modes:

    * ``peak_avg`` — peak / average (peak excluded) > threshold
      (reference do_acquisition.rs:229-238)
    * ``two_peak`` — first / second peak with a +/-``exclusion_samples``
      circular guard band around the first (legacy reference,
      acquisition_bk.rs:342-399, threshold 1.4)
    * ``cfar`` — peak > threshold * mean (legacy CA-CFAR,
      acquisition_bk.rs:306-340, threshold 2*invgammp(0.8,2) ~ 5.99)
    """
    n_fft = power.shape[-1]
    peak_per_bin = power.max(axis=-1)                       # [P, D]
    best_bin = jnp.argmax(peak_per_bin, axis=-1)            # [P]
    bin_power = jnp.take_along_axis(
        power, best_bin[:, None, None], axis=1
    )[:, 0, :]                                              # [P, N]
    code_phase = jnp.argmax(bin_power, axis=-1).astype(jnp.int32)
    peak = jnp.max(bin_power, axis=-1)
    if mode == "two_peak":
        lag = jnp.arange(n_fft, dtype=jnp.int32)[None, :]
        dist = jnp.abs(lag - code_phase[:, None])
        dist = jnp.minimum(dist, n_fft - dist)              # circular
        masked = jnp.where(
            dist <= exclusion_samples, -jnp.inf, bin_power
        )
        second = jnp.max(masked, axis=-1)
        ratio = peak / jnp.maximum(second, jnp.float32(1e-20))
    elif mode == "cfar":
        mean = jnp.mean(bin_power, axis=-1)
        ratio = peak / jnp.maximum(mean, jnp.float32(1e-20))
    else:
        avg = (jnp.sum(bin_power, axis=-1) - peak) / jnp.float32(n_fft - 1)
        ratio = peak / jnp.maximum(avg, jnp.float32(1e-20))

    return AcqResults(
        detected=ratio > jnp.float32(threshold),
        ratio=ratio,
        peak_power=peak,
        code_phase_samples=code_phase,
        carrier_freq_hz=carrier_freqs[best_bin],
        power=power if return_power else None,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "fs_hz", "n_int", "threshold", "return_power", "mode",
        "exclusion_samples", "pad_fft", "n_fft", "coherent",
        "bit_edge_hypotheses",
    ),
)
def pcps_search(
    samples: jax.Array,        # [n_int * N] complex64 (circular) or
                               # [(n_int+1) * N] (pad_fft linear path)
    code_ffts: jax.Array,      # [P, N] (circular) or [P, M] (pad_fft)
    carrier_freqs: jax.Array,  # [D] f32 = f_if + doppler grid
    *,
    fs_hz: float,
    n_int: int,
    threshold: float = 7.0,
    return_power: bool = False,
    mode: str = "peak_avg",
    exclusion_samples: int = 0,
    pad_fft: bool = False,
    n_fft: int | None = None,
    coherent: int = 1,
    bit_edge_hypotheses: int = 1,
) -> AcqResults:
    """Search all PRNs over all Doppler bins in one shot.

    ``pad_fft=True`` uses the power-of-two linear-correlation path
    (pcps_power_padded): pass ``code_ffts`` from
    ``code_replica_ffts_padded`` and supply ``n_fft`` (one code period
    in samples). ``bit_edge_hypotheses`` (circular path only) guards
    ``coherent`` grouping against data-bit sign flips — see
    pcps_power."""
    if pad_fft:
        if n_fft is None:
            raise ValueError("pad_fft path requires n_fft")
        if samples.shape[-1] != (n_int + 1) * n_fft:
            raise ValueError(
                f"pad_fft needs {(n_int + 1)}x{n_fft} samples, "
                f"got {samples.shape[-1]}"
            )
        power = pcps_power_padded(
            samples, code_ffts, carrier_freqs,
            fs_hz=fs_hz, n_int=n_int, n_fft=n_fft, coherent=coherent,
        )
    else:
        n_fft = code_ffts.shape[-1]
        if samples.shape[-1] != n_int * n_fft:
            raise ValueError(
                f"need {n_int}x{n_fft} samples, got {samples.shape[-1]}"
            )
        power = pcps_power(
            samples, code_ffts, carrier_freqs, fs_hz=fs_hz, n_int=n_int,
            coherent=coherent, bit_edge_hypotheses=bit_edge_hypotheses,
        )
    return detect(
        power, carrier_freqs, threshold, return_power,
        mode=mode, exclusion_samples=exclusion_samples,
    )


@functools.partial(
    jax.jit,
    static_argnames=("fs_hz", "n_int", "zero_pad", "window_hz", "squaring"),
)
def fine_doppler(
    samples: jax.Array,        # [n_int * N] complex64
    code_samples: jax.Array,   # [P, N] f32 +/-1 sampled replicas
    code_phase: jax.Array,     # [P] i32 from pcps_search
    coarse_freq: jax.Array,    # [P] f32 carrier (f_if + doppler) estimate
    *,
    fs_hz: float,
    n_int: int,
    zero_pad: int = 8,
    window_hz: float = 500.0,
    squaring: bool = False,
) -> jax.Array:
    """Refine the carrier frequency with a long zero-padded FFT.

    Capability parity with the reference's legacy fine-Doppler stage
    (reference: src/acquisition/acquisition_bk.rs:215-302): align the code
    replica at the acquired code phase, wipe the code off, and locate the
    residual carrier line in a ``zero_pad``-times zero-padded FFT of the
    full ``n_int`` ms. Resolution: fs / (zero_pad * n_int * N) Hz near the
    coarse bin. Returns the refined carrier frequency [P] f32.

    Redesign note: instead of the legacy's generic spectrum argmax, the
    search is windowed to +/- ``window_hz`` (set it to the coarse bin
    step) around the coarse estimate so a neighbouring satellite's line
    can never capture the refinement.

    ``squaring=True`` squares the code-stripped signal before the FFT,
    wiping residual BPSK modulation (secondary/NH codes, data bits) at
    the cost of halved resolution and squared noise — required for
    secondary-coded signals (e.g. BeiDou B1I NH), whose modulation
    otherwise splits and biases the carrier line.
    """
    n_fft = code_samples.shape[-1]
    length = n_int * n_fft
    pad_len = zero_pad * length

    def one(cp, code, f0):
        # roll the replica to the acquired phase and tile over n_int ms
        rep = jnp.roll(code, cp)
        rep_long = jnp.tile(rep, n_int)
        wiped = samples[:length] * rep_long  # code stripped (+/-1 chips)
        freqs = jnp.fft.fftfreq(pad_len, d=1.0 / fs_hz).astype(jnp.float32)
        if squaring:
            spec = jnp.fft.fft(wiped * wiped, n=pad_len)
            # the squared line sits at 2*f, which may alias: fold the
            # target into [-fs/2, fs/2) and search circularly around it
            fs_f = jnp.float32(fs_hz)
            target = jnp.mod(2.0 * f0 + fs_f / 2, fs_f) - fs_f / 2
            dist = jnp.abs(freqs - target)
            dist = jnp.minimum(dist, fs_f - dist)
            w = dist <= jnp.float32(2.0 * window_hz)
            mag = jnp.where(w, jnp.abs(spec), -jnp.inf)
            peak = freqs[jnp.argmax(mag)]
            # unalias: signed circular offset from the folded target
            delta = jnp.mod(peak - target + fs_f / 2, fs_f) - fs_f / 2
            return f0 + delta * 0.5
        spec = jnp.fft.fft(wiped, n=pad_len)
        # window around the coarse carrier estimate (one coarse bin)
        w = jnp.abs(freqs - f0) <= jnp.float32(window_hz)
        mag = jnp.where(w, jnp.abs(spec), -jnp.inf)
        return freqs[jnp.argmax(mag)]

    return jax.vmap(one)(code_phase, code_samples, coarse_freq)
