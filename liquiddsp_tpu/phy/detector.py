"""Batched preamble frame detector — the reference's frame_detector_cc /
liquid qdetector_cccf analog, redesigned block-dense for an accelerator.

The reference pushes samples one at a time through an FFT correlator
(lib/frame_detector_cc_impl.cc:76-83, template built at cc:46-55, threshold
0.45 at cc:55). Here a whole block [B, T] is correlated at once:

1. overlap-save FFT cross-correlation of the block against F frequency-shifted
   copies of the 128-sample pulse-shaped preamble template (multi-bin CFO
   tolerance, like qdetector's multi-bin search);
2. normalized correlation rho^2[tau] = max_f |c_f[tau]|^2 / (E_s * E_x[tau])
   with a sliding-window signal energy;
3. local-max suppression + threshold + top-K candidate extraction
   (static K: variable-rate detections as fixed slots + validity mask);
4. per-candidate estimates, the qdetector getters the reference intended to
   use (commented at lib/frame_detector_cc_impl.cc:89-93):
   tau_hat (fractional timing, parabolic interp), gamma_hat (gain),
   dphi_hat (CFO: coarse bin + fine dual-half phase slope), phi_hat (phase).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.ops import msequence, rrc
from liquiddsp_tpu.phy import frame_spec as fs

TEMPLATE_LEN = fs.K_SAMP * fs.PREAMBLE_SYMS  # 128 samples
DEFAULT_THRESHOLD = 0.45  # lib/frame_detector_cc_impl.cc:55
NFFT = 512  # overlap-save chunk
HOP = NFFT - TEMPLATE_LEN + 1  # valid lags per chunk
CFO_BINS = (-2, -1, 0, 1, 2)  # frequency offsets in units of 2*pi/NFFT... see below
# CFO bin spacing: one bin = 2*pi/TEMPLATE_LEN rad/sample after wrap — use
# template-length granularity so adjacent bins overlap at ~3 dB.


@functools.lru_cache(maxsize=None)
def template() -> np.ndarray:
    """The 128-sample pulse-shaped preamble template (data-independent
    prefix of every frame; see phy/frame_spec.py)."""
    pre = msequence.preamble_symbols()
    h = rrc.matched_taps()
    up = np.zeros(fs.K_SAMP * len(pre), dtype=np.complex64)
    up[:: fs.K_SAMP] = pre
    wave = np.convolve(up, h)
    return wave[:TEMPLATE_LEN].astype(np.complex64)


@functools.lru_cache(maxsize=None)
def templates_time() -> np.ndarray:
    """Frequency-shifted templates [F, TEMPLATE_LEN] complex64 (time domain)."""
    s = template()
    n = np.arange(TEMPLATE_LEN)
    bank = []
    for b in CFO_BINS:
        shift = np.exp(1j * 2.0 * np.pi * b * n / (2 * TEMPLATE_LEN))
        bank.append((s * shift).astype(np.complex64))
    return np.stack(bank).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _template_bank() -> np.ndarray:
    """Frequency-shifted conjugated template FFTs [F, NFFT] complex64."""
    return np.stack(
        [np.fft.fft(sf, NFFT).conj() for sf in templates_time()]
    ).astype(np.complex64)


def cfo_of_bin(b: int) -> float:
    """Carrier offset (rad/sample) of CFO bin index b."""
    return 2.0 * np.pi * b / (2 * TEMPLATE_LEN)


TAU_BANK_PHASES = 16
TAU_BANK_RANGE = 12  # delayed-template rows cover +-12/16 = +-0.75 samples


@functools.lru_cache(maxsize=None)
def _delayed_templates() -> np.ndarray:
    """[2R+1, TEMPLATE_LEN] preamble templates fractionally delayed by
    (q - R)/TAU_BANK_PHASES samples — delay-matched references for fine_cfo.

    Correlating a window whose true timing offset is delta against the
    UNdelayed template biases the dual-half CFO slope by ~0.01*delta
    rad/sample (the half-window partial correlations of the PN preamble at
    fractional lag acquire half-dependent phases). That residual CFO drifts
    ~70 deg across the preamble->header gap at delta=0.5 — beyond
    _carrier_fit's pi/4 branch budget — and was the dominant header-loss
    mode of the 10 dB FER floor (all failing trials had |frac| >= 0.41).
    Matching the template delay to the detector's tau estimate removes the
    bias to first order."""
    pre = msequence.preamble_symbols()
    rows = []
    for q in range(-TAU_BANK_RANGE, TAU_BANK_RANGE + 1):
        h = rrc.rrcos_taps(dt=q / TAU_BANK_PHASES)
        up = np.zeros(fs.K_SAMP * len(pre), dtype=np.complex64)
        up[:: fs.K_SAMP] = pre
        wave = np.convolve(up, h)
        rows.append(wave[:TEMPLATE_LEN])
    return np.stack(rows).astype(np.complex64)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Detections:
    """Top-K frame-start candidates per batch row (static shapes + masks).

    Registered as a pytree so it can cross jit/shard_map/scan boundaries."""

    mask: jax.Array  # [B, K] bool — candidate valid
    start: jax.Array  # [B, K] int32 — frame start sample index
    rho: jax.Array  # [B, K] float32 — normalized correlation amplitude
    gamma: jax.Array  # [B, K] float32 — gain estimate
    dphi: jax.Array  # [B, K] float32 — CFO estimate (rad/sample)
    phi: jax.Array  # [B, K] float32 — carrier phase at frame start
    tau: jax.Array  # [B, K] float32 — fractional timing (-0.5..0.5 samples)


def extract_windows(x: jax.Array, starts: jax.Array, n: int) -> jax.Array:
    """[B, T] complex, starts [B, K] int32 -> windows [B, K, n] complex64.

    Reads past T return zeros (the caller guarantees starts <= T-1). XLA
    lowers the vmapped slice to one gather that it fuses into consumers.
    """
    xp = jnp.pad(x, ((0, 0), (0, n)))
    return jax.vmap(
        lambda row, ss: jax.vmap(
            lambda s0: jax.lax.dynamic_slice_in_dim(row, s0, n), in_axes=0
        )(ss)
    )(xp, starts)


def correlate(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Overlap-save correlation of [B, T] against the template bank.

    Returns (corr [B, F, T] complex64 — <x[t:t+128], s_f>, energy [B, T]
    float32 — sliding 128-window energy). Lags T-127..T-1 are zero-padded.
    """
    b, t = x.shape
    nchunks = -(-t // HOP)
    pad_t = nchunks * HOP + TEMPLATE_LEN - 1
    xp = jnp.pad(x, ((0, 0), (0, pad_t - t)))
    # chunk i covers samples [i*HOP, i*HOP + NFFT)
    idx = (jnp.arange(nchunks) * HOP)[:, None] + jnp.arange(NFFT)[None, :]
    chunks = xp[:, idx]  # [B, nchunks, NFFT]
    cf = jnp.fft.fft(chunks, axis=-1)
    bank = jnp.asarray(_template_bank())  # [F, NFFT]
    prod = cf[:, :, None, :] * bank[None, None, :, :]
    corr = jnp.fft.ifft(prod, axis=-1)[..., :HOP]  # valid lags
    corr = jnp.moveaxis(corr, 2, 1).reshape(b, len(CFO_BINS), nchunks * HOP)
    corr = corr[..., :t].astype(jnp.complex64)
    # sliding window energy over 128 samples
    p = jnp.abs(xp) ** 2
    cs = jnp.cumsum(p, axis=-1)
    cs = jnp.pad(cs, ((0, 0), (1, 0)))
    energy = cs[:, TEMPLATE_LEN:] - cs[:, :-TEMPLATE_LEN]  # [B, pad_t-127]
    energy = energy[:, :t]
    return corr, energy


def fine_cfo(
    wins: jax.Array, coarse: jax.Array, tau: jax.Array | None = None
) -> jax.Array:
    """Fine CFO from raw preamble windows [..., TEMPLATE_LEN]: derotate by
    the coarse (bin) estimate, then dual-half correlation phase slope against
    the template — the qdetector residual-offset refinement.

    ``tau`` (the detector's fractional-timing estimate, samples) selects a
    delay-matched template row (_delayed_templates); without it the
    estimator carries a ~0.01*tau rad/sample bias."""
    if tau is None:
        s = jnp.asarray(template())
    else:
        bank = jnp.asarray(_delayed_templates())
        q = jnp.clip(
            jnp.round(tau * TAU_BANK_PHASES).astype(jnp.int32),
            -TAU_BANK_RANGE,
            TAU_BANK_RANGE,
        ) + TAU_BANK_RANGE
        s = bank[q]  # [..., TEMPLATE_LEN]
    half = TEMPLATE_LEN // 2
    n = jnp.arange(TEMPLATE_LEN, dtype=jnp.float32)
    derot = jnp.exp(-1j * coarse[..., None] * n)
    wins_d = wins * derot
    c1 = jnp.sum(wins_d[..., :half] * jnp.conj(s[..., :half]), axis=-1)
    c2 = jnp.sum(wins_d[..., half:] * jnp.conj(s[..., half:]), axis=-1)
    return jnp.angle(c2 * jnp.conj(c1)) / half


def detect(
    x: jax.Array,
    max_frames: int,
    threshold: float = DEFAULT_THRESHOLD,
    min_spacing: int = TEMPLATE_LEN,
    backend: str | None = None,
    fine: bool = True,
    return_count: bool = False,
):
    """Find up to ``max_frames`` preamble hits in [B, T] samples.

    Static output shapes; invalid slots are masked. ``min_spacing`` sets the
    local-max suppression block size; the block-hierarchical formulation
    below gives an *effective* suppression radius between min_spacing and
    2*min_spacing samples (a peak must dominate its own block and both
    neighbors), so two genuine frames must start > 2*min_spacing apart to
    both be reported. Frames are in practice far longer than that (the
    shortest frame is ~536 samples vs the default 128). ``backend`` is
    the correlator's (kernels/correlator.correlate_reduced; None picks by
    platform). ``fine=False`` skips the fine CFO refinement
    (dphi is then the coarse bin center) — used by the framesync, which
    refines from its own frame windows instead of re-extracting preambles.
    ``return_count=True`` additionally returns the TOTAL threshold-passing
    peak count per row [B] int32 (BEFORE the top-K cut) — the demand
    signal the occupancy-adaptive streaming decode sizes its slot count
    from (runtime/stream.py run_adaptive): count > K means top-K dropped
    real candidates.
    """
    from liquiddsp_tpu.kernels.correlator import correlate_reduced

    b, t = x.shape
    es = float(np.sum(np.abs(template()) ** 2))
    red = correlate_reduced(x, templates_time(), backend=backend)
    energy = red["energy"]
    best_f = red["fbin"]  # [B, T]
    corr_best = red["corr"]  # [B, T] complex — correlation at best bin
    rho2 = jnp.where(energy > 1e-9, red["rho2"], 0.0)

    # local-max suppression, block-hierarchical: a candidate must be the max
    # of its own min_spacing-sample block and both neighbor blocks
    # (suppression radius min_spacing..2*min_spacing — frames are always
    # farther apart than that). The block-max + neighbor-max formulation is
    # three cheap reductions, where a reduce_window over +/-min_spacing
    # would unroll a large window.
    blk = min_spacing
    nb = -(-t // blk)
    rp = jnp.pad(rho2, ((0, 0), (0, nb * blk - t)), constant_values=-1.0)
    rb = rp.reshape(b, nb, blk)
    bm = jnp.max(rb, axis=-1)  # [B, nb]
    am = jnp.argmax(rb, axis=-1).astype(jnp.int32)  # [B, nb] in-block offset
    left = jnp.pad(bm, ((0, 0), (1, 0)), constant_values=-jnp.inf)[:, :-1]
    right = jnp.pad(bm, ((0, 0), (0, 1)), constant_values=-jnp.inf)[:, 1:]
    # a block's max is a peak iff it dominates both neighbor blocks (radius
    # min_spacing..2*min_spacing suppression; frames are farther apart) —
    # and top-k then runs over nb blocks, not T lags (a full-length
    # lax.top_k over T was a hot spot: it sorts the whole row)
    is_peak = (bm >= left) & (bm >= right) & (bm > threshold * threshold)
    score = jnp.where(is_peak, bm, -1.0)  # [B, nb]
    top_rho2, bstart = jax.lax.top_k(score, max_frames)  # [B, K]
    mask = top_rho2 > 0
    start = bstart * blk + jnp.take_along_axis(am, bstart, axis=1)
    start = jnp.minimum(start, t - 1)

    # gather per-candidate quantities
    bidx = jnp.arange(b)[:, None]
    fbin = best_f[bidx, start]  # [B, K]
    cpk = jnp.take_along_axis(corr_best, start, axis=1)  # [B, K] complex
    epk = jnp.take_along_axis(energy, start, axis=1)
    gamma = jnp.sqrt(jnp.maximum(epk, 1e-12) / es)
    phi = jnp.angle(cpk)

    # fractional timing: parabolic interpolation of rho2 around the peak
    t_idx = jnp.clip(start, 1, t - 2)
    ym = jnp.take_along_axis(rho2, t_idx - 1, axis=1)
    y0 = jnp.take_along_axis(rho2, t_idx, axis=1)
    yp = jnp.take_along_axis(rho2, t_idx + 1, axis=1)
    denom = ym - 2 * y0 + yp
    tau = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
    tau = jnp.clip(tau, -0.5, 0.5)

    # CFO: coarse (best bin) + optional fine (dual-half phase slope)
    coarse = jnp.asarray([cfo_of_bin(bb) for bb in CFO_BINS], dtype=jnp.float32)[fbin]
    if fine:
        wins = extract_windows(x, jnp.clip(start, 0, t - 1), TEMPLATE_LEN)
        dphi = coarse + fine_cfo(wins, coarse, tau)
    else:
        dphi = coarse

    det = Detections(
        mask=mask,
        start=start.astype(jnp.int32),
        rho=jnp.sqrt(jnp.maximum(top_rho2, 0.0)),
        gamma=gamma.astype(jnp.float32),
        dphi=dphi.astype(jnp.float32),
        phi=phi.astype(jnp.float32),
        tau=tau.astype(jnp.float32),
    )
    if return_count:
        return det, jnp.sum(is_peak.astype(jnp.int32), axis=-1)
    return det


def frame_detector_cc(x: jax.Array, max_frames: int = 16, threshold: float = DEFAULT_THRESHOLD):
    """Stream-block API parity with the reference's frame_detector_cc
    (1-in/1-out passthrough + detection count,
    lib/frame_detector_cc_impl.cc:66-97): returns (passthrough, num_detected,
    detections)."""
    det = detect(x, max_frames, threshold)
    return x, jnp.sum(det.mask, axis=-1), det
