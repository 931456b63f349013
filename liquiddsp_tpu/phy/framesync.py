"""Frame synchronizer (RX): the reference's flex_rx / liquid flexframesync
analog, restructured block-dense for an accelerator.

liquid's flexframesync is a per-sample sequential state machine (AGC ->
qdetector -> NCO mix -> matched-filter decim -> header demod/decode ->
payload demod/decode -> callback; SURVEY.md section 3.2). This design
processes a whole block [B, T] at once (SURVEY.md section 7.3):

1. dense preamble detection over the block (phy/detector.py) -> top-K
   candidate frame starts with tau/gamma/dphi/phi estimates;
2. per-candidate frame extraction (static max length) + NCO derotation +
   gain normalization;
3. matched filter with a fractional-delay RRC bank (timing recovery) +
   k=2 decimation -> symbol estimates;
4. header demod (QPSK) -> Golay decode -> CRC24 -> header_valid + config
   fields (self-describing frames, like flexframesync's header-driven payload
   config at lib/flex_rx_impl.cc:232-234);
5. decision-directed carrier refinement on the header symbols, then payload
   demod -> deinterleave -> inner (Viterbi) -> outer decode -> CRC24 ->
   payload_valid.

Outputs mirror the reference's per-frame callback payload
(lib/flex_rx_impl.cc:181-201 packet_info): header/payload bytes, validity
flags, config indices, frame symbols ("constellation" port), EVM/RSSI stats.
All shapes are static: [B, K] frame slots with validity masks.

Single-config fast path: ``framesync_fixed`` decodes payloads assuming one
static (mod, fec) config — the bench/streaming path. The header-dispatched
multi-config path lives in runtime/blocks.py (host dispatch over compiled
per-config decoders, cached — no recompiles in the adaptation loop).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.core.config import MOD_BPS, FrameConfig
from liquiddsp_tpu.ops import bits as bitops
from liquiddsp_tpu.ops import crc, modem, rrc
from liquiddsp_tpu.ops.fec import registry
from liquiddsp_tpu.ops.fec.block import golay2412
from liquiddsp_tpu.phy import frame_spec as fs
from liquiddsp_tpu.phy.detector import Detections, detect, extract_windows

NUM_TIMING_PHASES = 32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FrameResults:
    """Per-candidate decode results, [B, K] slots (masked).

    Registered as a pytree so it can cross jit/shard_map/scan boundaries."""

    mask: jax.Array  # [B, K] bool — detection valid
    header_valid: jax.Array  # [B, K] bool — header CRC passed
    payload_valid: jax.Array  # [B, K] bool — payload CRC passed
    modulation: jax.Array  # [B, K] int32 — from decoded header
    inner_code: jax.Array  # [B, K] int32
    outer_code: jax.Array  # [B, K] int32
    payload_len: jax.Array  # [B, K] int32
    header_user: jax.Array  # [B, K, 14] uint8
    payload: jax.Array  # [B, K, payload_len] uint8
    symbols: jax.Array  # [B, K, n_syms] complex64 — the constellation port
    evm: jax.Array  # [B, K] float32 — header-symbol EVM (dB)
    rssi: jax.Array  # [B, K] float32 — estimated gain (dB)
    cfo: jax.Array  # [B, K] float32 — carrier offset estimate (rad/sample)
    start: jax.Array  # [B, K] int32 — frame start sample
    # host-side 2^30 base of ``start`` for long streams: absolute sample
    # index = epoch + start. Static (aux) pytree data — always 0 inside
    # device programs; StreamingRx stamps the true value on each returned
    # result so multi-result calls (push/run) stay exactly-once safe.
    epoch: int = dataclasses.field(default=0, metadata=dict(static=True))


# ---------------------------------------------------------------------------
# candidate extraction + symbol recovery
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _timing_bank() -> np.ndarray:
    return rrc.fractional_delay_bank(NUM_TIMING_PHASES)


@functools.lru_cache(maxsize=None)
def _timing_bank30() -> np.ndarray:
    """Reversed 30-tap fractional-delay bank indexed by q = round(tau*P)+P/2.

    Folds the integer base shift for negative tau into the filter itself
    (one zero pad position), so symbol recovery needs no per-candidate
    dynamic offsets: sym[s] = sum_v win[2s+v] * bank30[q, v]. bank30[q] is
    the time-reversed bank[p] (p = q - P/2, wrapped as in the classic
    convolve formulation) placed at offset ``base``.
    """
    p_half = NUM_TIMING_PHASES // 2
    bank = _timing_bank()  # [P, 29]
    out = np.zeros((NUM_TIMING_PHASES + 1, fs.PULSE_LEN + 1), dtype=np.float32)
    for q in range(NUM_TIMING_PHASES + 1):
        p = q - p_half
        base = 1 if p < 0 else 0
        pp = p + NUM_TIMING_PHASES if p < 0 else p
        out[q, base : base + fs.PULSE_LEN] = bank[pp][::-1]
    return out


SFO_SEG = 64  # symbols per timing-tracking segment
SFO_AUTO_SYMS = 2200  # auto-enable tracking for frames longer than this


@functools.lru_cache(maxsize=None)
def _timing_bank65() -> np.ndarray:
    """Extended fractional-delay bank covering a +-1.0-sample range for
    symbol-timing (SFO) tracking: row q samples the matched-filter output
    at nominal + (q - P)/P samples, q in [0, 2P].

    Same construction as _timing_bank30 but with the integer sample shift
    folded over a 3-position base range, and a global +1 placement so the
    caller reads the window with a one-sample front pad:
    y[s] = sum_v winp[2s+v] * bank65[q, v], winp = [0, win...].
    """
    p_half = NUM_TIMING_PHASES
    bank = _timing_bank()  # [P, 29]
    W = fs.PULSE_LEN + 3  # 32 taps (lane-friendly; last tap always zero)
    out = np.zeros((2 * p_half + 1, W), dtype=np.float32)
    for q in range(2 * p_half + 1):
        p = q - p_half  # sampling offset p/P in [-1, 1]
        a = int(np.floor(p / p_half))  # integer sample shift {-1, 0, 1}
        pp = p - a * p_half  # fractional phase in [0, P)
        base = 1 - a  # {0, 1, 2}
        out[q, base : base + fs.PULSE_LEN] = bank[pp][::-1]
    return out


def _segment_recover(win_d: jax.Array, q_seg: jax.Array, n_syms: int, seg: int) -> jax.Array:
    """Per-segment polyphase matched filter + k=2 decimation.

    ``win_d`` [B, K, n_samp] derotated candidate windows; ``q_seg``
    [B, K, nseg] per-segment rows of _timing_bank65 (the tracked sampling
    instant). Segment windows are static slices (no gathers); the bank row
    lookup is the only data-dependent indexing. Returns [B, K, n_syms].
    """
    nseg = q_seg.shape[-1]
    L = 2 * seg + 30
    need = 2 * seg * (nseg - 1) + L
    lead = [(0, 0)] * (win_d.ndim - 1)
    winp = jnp.pad(win_d, lead + [(1, max(0, need - win_d.shape[-1] - 1))])
    segw = jnp.stack(
        [winp[..., 2 * seg * s : 2 * seg * s + L] for s in range(nseg)], axis=-2
    )  # [B, K, nseg, L]
    taps = jnp.asarray(_timing_bank65())[q_seg]  # [B, K, nseg, 32]
    we = segw[..., 0::2]
    wo = segw[..., 1::2]
    y = jnp.zeros(q_seg.shape + (seg,), dtype=jnp.complex64)
    for j in range(16):
        y = y + we[..., j : j + seg] * taps[..., 2 * j, None]
        y = y + wo[..., j : j + seg] * taps[..., 2 * j + 1, None]
    return y.reshape(y.shape[:-2] + (nseg * seg,))[..., :n_syms]


def _sfo_fit(win_d: jax.Array, tau: jax.Array, nseg: int, seg: int) -> jax.Array:
    """Estimate the per-segment sampling-instant trajectory u(s) = a + b*s
    (residual timing offset + sample-clock drift) and return bank65 rows
    [B, K, nseg].

    Decision-free power metric: the matched-filter output power over a
    segment peaks at the correct sampling instant (the RRC timing tone,
    beta=0.3). Five trial offsets spanning +-0.5 sample are evaluated with
    the same segment-recovery FMA; a per-segment parabolic vertex around
    the best trial gives u_s, and a contrast-weighted least-squares line
    over segments smooths it into the (offset, drift) model — the
    block-dense analog of liquid's PFB timing-recovery loop (SURVEY.md
    section 2.2 AGC/NCO/symbol-sync row). The fitted drift is clipped to
    +-100 ppm so a noise-floor fit can never do worse than the static path
    by more than a bank step or two.
    """
    P = NUM_TIMING_PHASES
    deltas = np.array([-0.5, -0.25, 0.0, 0.25, 0.5], dtype=np.float32)
    powers = []
    for d in deltas:
        q = jnp.clip(jnp.round((-tau + d) * P).astype(jnp.int32), -P, P) + P
        qs = jnp.broadcast_to(q[..., None], q.shape + (nseg,))
        y = _segment_recover(win_d, qs, nseg * seg, seg)
        p = jnp.sum(
            jnp.abs(y.reshape(y.shape[:-1] + (nseg, seg))) ** 2, axis=-1
        )  # [B, K, nseg]
        powers.append(p)
    M = jnp.stack(powers, axis=-1)  # [B, K, nseg, 5]

    jbest = jnp.clip(jnp.argmax(M, axis=-1), 1, 3)  # interior for the parabola
    take = lambda off: jnp.take_along_axis(M, (jbest + off)[..., None], axis=-1)[..., 0]
    m_lo, m_0, m_hi = take(-1), take(0), take(1)
    denom = m_lo - 2.0 * m_0 + m_hi
    vert = 0.125 * (m_lo - m_hi) / jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
    vert = jnp.clip(vert, -0.125, 0.125)
    u_s = -tau[..., None] + deltas[1] + 0.25 * (jbest - 1).astype(jnp.float32) + vert

    # contrast-weighted LS line u(s) = a + b*s over segments
    w = jnp.maximum(jnp.max(M, axis=-1) - jnp.min(M, axis=-1), 0.0) ** 2
    s_idx = jnp.arange(nseg, dtype=jnp.float32)
    wsum = jnp.maximum(jnp.sum(w, axis=-1), 1e-20)
    s_bar = jnp.sum(w * s_idx, axis=-1) / wsum
    u_bar = jnp.sum(w * u_s, axis=-1) / wsum
    ds = s_idx - s_bar[..., None]
    var = jnp.maximum(jnp.sum(w * ds**2, axis=-1), 1e-20)
    b = jnp.sum(w * ds * u_s, axis=-1) / var
    b = jnp.clip(b, -2e-4 * 2 * seg, 2e-4 * 2 * seg)  # +-100 ppm drift cap
    a = u_bar - b * s_bar
    u_fit = a[..., None] + b[..., None] * s_idx
    return jnp.clip(jnp.round(u_fit * P).astype(jnp.int32), -P, P) + P


def _sfo_recover(win: jax.Array, det: Detections, n_syms: int, seg: int = SFO_SEG) -> jax.Array:
    """Symbol recovery with sample-clock-drift (SFO) tracking: estimate the
    sampling-instant trajectory across the frame and matched-filter each
    segment at its own fractional delay. Handles TX/RX clock offsets that
    walk the symbol grid across long frames (the static per-frame tau of
    symbols_from_windows drifts off by >0.1 sample beyond ~2500 symbols at
    50 ppm)."""
    win_d = _derotate_window(win, det)
    nseg = -(-n_syms // seg)
    q_seg = _sfo_fit(win_d, det.tau, nseg, seg)
    return _segment_recover(win_d, q_seg, n_syms, seg)


def _derotate_window(win: jax.Array, det: Detections) -> jax.Array:
    """NCO derotation + gain normalization of candidate windows [B, K, S].

    The rotation exp(-j(dphi*n+phi)) is built as a coarse x fine outer
    product — 2 complex multiplies per sample instead of one transcendental
    (a dense jnp.exp over [B,K,S] was ~10x the arithmetic cost of the
    rotation itself)."""
    n_samples = win.shape[-1]
    fine_n = 32
    n_coarse = -(-n_samples // fine_n)
    nf = jnp.arange(fine_n, dtype=jnp.float32)
    ncs = jnp.arange(n_coarse, dtype=jnp.float32) * fine_n
    e_fine = jnp.exp(-1j * det.dphi[..., None] * nf)  # [B, K, fine]
    e_coarse = jnp.exp(
        -1j * (det.dphi[..., None] * ncs + det.phi[..., None])
    )  # [B, K, coarse]
    nco = (e_coarse[..., :, None] * e_fine[..., None, :]).reshape(
        det.start.shape + (n_coarse * fine_n,)
    )[..., :n_samples]
    return win * nco / jnp.maximum(det.gamma[..., None], 1e-9)


def extract_symbols(
    x: jax.Array, det: Detections, n_syms: int, timing_bank: bool = True
) -> jax.Array:
    """Recover [B, K, n_syms] symbol estimates for each candidate frame.

    Applies gain normalization, NCO derotation (CFO + phase), matched
    filtering with the per-candidate fractional-delay filter, and k=2
    decimation. ``n_syms`` is static (max frame symbols).
    """
    n_samples = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    win = extract_windows(x, det.start, n_samples)
    return symbols_from_windows(win, det, n_syms, timing_bank)


def symbols_from_windows(
    win: jax.Array, det: Detections, n_syms: int, timing_bank: bool = True
) -> jax.Array:
    """Per-candidate raw windows [B, K, 2*n_syms + PULSE_TAIL] -> symbol
    estimates [B, K, n_syms].

    Matched filter + decimation as a 15-tap polyphase FMA over the
    even/odd sample phases — 30 statically-sliced fused multiply-adds over
    [B, K, n_syms], no per-candidate convolution — which XLA fuses with the
    derotation into one loop.

    ``timing_bank=False`` skips per-candidate fractional-delay selection
    (all candidates share the symmetric prototype).
    """
    win = _derotate_window(win, det)
    half = (fs.PULSE_LEN + 1) // 2  # 15 taps per polyphase arm
    taps30 = _candidate_taps30(det, timing_bank)
    we = win[..., 0::2]  # [B, K, n_syms + half - 1]
    wo = win[..., 1::2]
    y = jnp.zeros(det.start.shape + (n_syms,), dtype=jnp.complex64)
    for j in range(half):
        y = y + we[..., j : j + n_syms] * taps30[..., 2 * j, None]
        y = y + wo[..., j : j + n_syms] * taps30[..., 2 * j + 1, None]
    return y.astype(jnp.complex64)


def _candidate_taps30(det: Detections, timing_bank: bool) -> jax.Array:
    """Per-candidate 30-tap matched-filter rows [B, K, 30].

    The detector's tau is "signal arrives tau samples late"; sampling at
    the fixed even decimation grid must then be *advanced* by tau, which
    the bank's delay-indexed rows express as row -tau (verified to -50 dB
    EVM against injected fractional delays)."""
    if timing_bank:
        p_half = NUM_TIMING_PHASES // 2
        q = jnp.clip(
            jnp.round(-det.tau * NUM_TIMING_PHASES).astype(jnp.int32), -p_half, p_half
        ) + p_half
        return jnp.asarray(_timing_bank30())[q]
    t30 = np.zeros(fs.PULSE_LEN + 1, dtype=np.float32)
    t30[: fs.PULSE_LEN] = rrc.matched_taps()[::-1]
    return jnp.broadcast_to(jnp.asarray(t30), det.start.shape + (fs.PULSE_LEN + 1,))


def decode_header_full(hdr_syms: jax.Array):
    """[..., 180] header symbols -> ((header_valid, user_bytes[...,14],
    payload_len, modulation, inner, outer), hdr_bytes[..., 22]).

    The raw corrected 22 header bytes are returned too so the equalizer can
    re-encode them as a training reference (_header_reference_symbols)."""
    idx = modem.demod_hard(hdr_syms, fs.HEADER_MOD)
    coded = modem.indices_to_bits(idx, 2)  # [..., 360]
    bits = golay2412().decode(coded)[..., : fs.HEADER_BITS]
    hdr = bitops.bits_to_bytes(bits)  # [..., 22]
    valid = crc.crc24_check(hdr)
    user = hdr[..., : fs.HEADER_USER_BYTES]
    plen = (hdr[..., 14].astype(jnp.int32) << 8) | hdr[..., 15].astype(jnp.int32)
    mod = hdr[..., 16].astype(jnp.int32)
    inner = hdr[..., 17].astype(jnp.int32)
    outer = hdr[..., 18].astype(jnp.int32)
    return (valid, user, plen, mod, inner, outer), hdr


def decode_header(hdr_syms: jax.Array):
    """[..., 180] header symbols -> (header_valid, user_bytes[...,14],
    payload_len, modulation, inner, outer)."""
    return decode_header_full(hdr_syms)[0]


def decode_header_multi(regions: list[jax.Array]):
    """Decode W candidate header streams ([..., 180] each) in one pass:
    returns the decode_header_full tuple with a [..., W] branch axis
    (bytes: [..., W, 22]).

    The branches are CONCATENATED on the symbol axis ([..., W*180]) rather
    than stacked on a new one, so the symbol-domain ops (demod, bit
    unpack, syndrome matmul) see one long minor axis instead of a short
    W axis. 180 symbols = 15 Golay blocks exactly, so block
    boundaries never straddle a branch seam."""
    w = len(regions)
    cat = jnp.concatenate(regions, axis=-1)  # [..., W*180]
    idx = modem.demod_hard(cat, fs.HEADER_MOD)
    coded = modem.indices_to_bits(idx, 2)  # [..., W*360]
    bits = golay2412().decode(coded)  # [..., W*180] data bits
    per = fs.HEADER_SYMS  # 180 data bits per branch (15 blocks x 12)
    hdr = jnp.stack(
        [
            bitops.bits_to_bytes(bits[..., b * per : b * per + fs.HEADER_BITS])
            for b in range(w)
        ],
        axis=-2,
    )  # [..., W, 22]
    valid = crc.crc24_check(hdr)
    user = hdr[..., : fs.HEADER_USER_BYTES]
    plen = (hdr[..., 14].astype(jnp.int32) << 8) | hdr[..., 15].astype(jnp.int32)
    mod = hdr[..., 16].astype(jnp.int32)
    inner = hdr[..., 17].astype(jnp.int32)
    outer = hdr[..., 18].astype(jnp.int32)
    return (valid, user, plen, mod, inner, outer), hdr


# ---------------------------------------------------------------------------
# linear equalizer (flexframesync's EQ stage; SURVEY.md section 2.2)
# ---------------------------------------------------------------------------

EQ_TAPS = 8


def _chol_solve_spd(M: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve via an unrolled Cholesky, vectorized over the batch.

    ``jnp.linalg.solve`` on [..., n, n] tiny systems lowers to a
    sequential LU per system. With n static and small (16), an unrolled
    Cholesky + two substitutions is O(n^2) elementwise vector ops over the
    batch, which XLA fuses completely.
    """
    n = M.shape[-1]
    mask = [
        jnp.asarray((np.arange(n) >= j).astype(np.float32)) for j in range(n)
    ]
    cols = []  # cols[j] = L[..., :, j] (zeros above the diagonal)
    diags = []  # clamped pivots d_j — divide by these, not cols[j][..., j]:
    # for a degenerate all-zero batch slot (masked detection, lam=0) the
    # unclamped diagonal is exactly 0 and 0/0 would poison the taps with
    # NaN; d_j >= 1e-10 keeps the output finite (identical for SPD inputs)
    for j in range(n):
        c = M[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j : j + 1]
        d = jnp.sqrt(jnp.maximum(c[..., j : j + 1], 1e-20))
        cols.append((c / d) * mask[j])
        diags.append(d[..., 0])
    # forward substitution: L y = b
    y = []
    for j in range(n):
        s = b[..., j]
        for k in range(j):
            s = s - cols[k][..., j] * y[k]
        y.append(s / diags[j])
    # back substitution: L^T x = y
    x = [None] * n
    for j in reversed(range(n)):
        s = y[j]
        for k in range(j + 1, n):
            s = s - cols[j][..., k] * x[k]
        x[j] = s / diags[j]
    return jnp.stack(x, axis=-1)


def _eq_train(
    syms: jax.Array,
    ref: jax.Array,
    lam_rel: float = 1e-3,
    static_ref: np.ndarray | None = None,
) -> jax.Array:
    """Train a symbol-spaced linear equalizer on known reference symbols.

    liquid's flexframesync adapts an LMS equalizer sample-by-sample through
    the preamble/header (SURVEY.md section 2.2 flexframesync row); a
    sequential LMS is a poor fit for a batched accelerator. Round 1-4 solved the *direct*
    Wiener problem (LS of reference on received); that estimator overfits
    the FIXED training sequences' self-correlations — the preamble is one
    deterministic m-sequence and the header is near-deterministic, so the
    LS exploits their nonzero lag correlations to reconstruct training
    gain through spread taps that act as pure ISI (~2% of signal power)
    plus a P/(P+sigma^2) payload gain collapse on the random payload.
    Measured r5 (bench/FER_LADDER.json): ~0.5 dB of AWGN implementation
    loss, the dominant term of the FER-vs-theory gap.

    This is the *indirect* (estimate-then-invert) design, which has none
    of those pathologies:

    1. *Channel estimate*: LS of received on the KNOWN CLEAN reference,
       syms[m] = sum_t h[t] ref[m+c-t] + noise. Regressors are noiseless,
       so there is no errors-in-variables shrinkage and noise can only
       enter h with variance sigma^2 tr((D^H D)^-1) ~ sigma^2 L/N.
    2. *Model-order gate* (positive-part James-Stein) on the ISI taps
       only: h' = h_c delta + kappa (h - h_c delta), kappa = (1 -
       null/|isi|)_+ with null = sigma^2 (L-1)/(N P) the pure-noise
       expectation. On clean AWGN kappa -> 0 (identity channel, EQ
       becomes exact passthrough); under a real echo |isi| >> null and
       kappa -> 1. The lag-0 tap h_c (2 real params, noise ~sigma^2/N) is
       always kept: it corrects the detector's noise-biased gamma and any
       residual constant phase — the QAM grids decide on absolute scale.
    3. *Ensemble MMSE inverse*: w solves (P R + sigma^2 I) w = P conj(hbar)
       where R[i,j] = sum_m h'[m] conj(h'[m - (i-j)]) is the channel
       autocorrelation implied by h' (ensemble quantities — no sample
       correlations anywhere) and hbar[i] = h'[2c-i] (both h' and w use
       the centered tap convention of _eq_apply).
    4. *Unbiasing*: MMSE output gain under the model is
       g0 = sum_t w[t] h'[c-t] < 1 (Wiener shrinkage); w /= g0 restores
       the unit decision scale.

    ``ref``: [n_ref] or [..., n_ref] known symbols aligned with
    ``syms[..., :n_ref]``. Returns taps [..., EQ_TAPS] for _eq_apply.
    """
    L = EQ_TAPS
    c = L // 2
    n0 = L - 1 - c
    n_ref = ref.shape[-1]
    rows = n_ref - L + 1  # targets m = n0 .. n_ref-1-c: full regressor span
    y = syms[..., n0 : n0 + rows]
    if static_ref is not None:
        # KNOWN-constant reference (the preamble): the design matrix, its
        # Gram, and the regularized LS estimator are all compile-time
        # numpy — the channel estimate is ONE [L, rows] matmul per frame
        # instead of Gram einsums + an 8-dim solve
        rnp = np.asarray(static_ref, dtype=np.complex64)
        D_np = np.stack(
            [rnp[n0 + c - t : n0 + c - t + rows] for t in range(L)], axis=-1
        )
        G_np = D_np.conj().T @ D_np
        lam_np = lam_rel * max(float(np.mean(np.real(np.diag(G_np)))), 1e-12)
        A_est = np.linalg.inv(G_np + lam_np * np.eye(L)) @ D_np.conj().T
        h = jnp.einsum(
            "lr,...r->...l", jnp.asarray(A_est.astype(np.complex64)), y
        )
        resid = y - jnp.einsum(
            "rl,...l->...r", jnp.asarray(D_np.astype(np.complex64)), h
        )
        p_train = float(np.mean(np.abs(rnp) ** 2))
    else:
        ref_b = jnp.broadcast_to(ref, syms.shape[:-1] + (n_ref,))
        # D[n, t] = ref[n0 + n + c - t]; y[n] = syms[n0 + n]
        D = jnp.stack(
            [ref_b[..., n0 + c - t : n0 + c - t + rows] for t in range(L)],
            axis=-1,
        )  # [..., rows, L]
        # Gram + cross-correlation as bf16 real matmuls: these are
        # noise-averaged statistics over ``rows`` symbols, so bf16's ~0.4%
        # operand rounding perturbs the solved taps ~0.5% — phantom ISI at
        # -46 dB, below the James-Stein gate's noise null at any
        # operational SNR (same accumulate-in-f32 policy as the template
        # correlator).
        Dr = jnp.real(D).astype(jnp.bfloat16)
        Di = jnp.imag(D).astype(jnp.bfloat16)
        mm = lambda a, b: jnp.einsum(
            "...nl,...nm->...lm", a, b, preferred_element_type=jnp.float32
        )
        Grr = mm(Dr, Dr) + mm(Di, Di)
        Gri = mm(Dr, Di) - mm(Di, Dr)
        G = (Grr + 1j * Gri).astype(jnp.complex64)
        yr = jnp.real(y).astype(jnp.bfloat16)
        yi = jnp.imag(y).astype(jnp.bfloat16)
        mv = lambda a, b: jnp.einsum(
            "...nl,...n->...l", a, b, preferred_element_type=jnp.float32
        )
        rhs = (
            (mv(Dr, yr) + mv(Di, yi)) + 1j * (mv(Dr, yi) - mv(Di, yr))
        ).astype(jnp.complex64)
        diag = jnp.real(jnp.diagonal(G, axis1=-2, axis2=-1))
        lam = lam_rel * jnp.maximum(jnp.mean(diag, axis=-1), 1e-12)
        G = G + (lam[..., None, None] * jnp.eye(L, dtype=G.dtype))
        h = _solve_hermitian(G, rhs)  # [..., L] channel estimate
        resid = y - jnp.einsum("...nl,...l->...n", D, h)
        p_train = jnp.maximum(jnp.mean(jnp.abs(ref_b) ** 2, axis=-1), 1e-12)

    # noise estimate from the channel-fit residual (bias-corrected)
    sigma2 = jnp.mean(jnp.abs(resid) ** 2, axis=-1) * (rows / max(rows - L, 1))
    p_train = jnp.asarray(p_train, jnp.float32)  # 0-d on the static path

    # James-Stein gate on the ISI taps (lag-0 always kept)
    delta = jnp.zeros((L,), dtype=h.dtype).at[c].set(1.0)
    hc = h[..., c]
    e = h - hc[..., None] * delta
    isi = jnp.sum(jnp.abs(e) ** 2, axis=-1)
    null = sigma2 * ((L - 1) / rows) / p_train
    kappa = jnp.clip(1.0 - null / jnp.maximum(isi, 1e-20), 0.0, 1.0)
    h = hc[..., None] * delta + kappa[..., None].astype(h.dtype) * e

    # ensemble MMSE equalizer for (h, sigma2): M w = rhs_w with
    # M[i, j] = P R[i - j] + sigma2 I, rhs_w[i] = P conj(h[c - i])
    hp = jnp.pad(h, [(0, 0)] * (h.ndim - 1) + [(L, 2 * L - 1)])  # safe lags
    R = jnp.stack(
        [
            jnp.sum(
                hp[..., L : 3 * L] * jnp.conj(hp[..., L - k : 3 * L - k]), axis=-1
            )
            for k in range(-(L - 1), L)
        ],
        axis=-1,
    )  # [..., 2L-1], R[k + L-1] = sum_m h[m] conj(h[m-k])
    ii = np.arange(L)
    M = (
        p_train[..., None, None] * R[..., (ii[:, None] - ii[None, :]) + L - 1]
        + sigma2[..., None, None] * jnp.eye(L, dtype=h.dtype)
    )
    # h is estimated in the same centered convention as w (tap t multiplies
    # a (t - c)-delayed symbol), so the equalizer cascade's signal path is
    # h[2c - i]: hbar[i] = h[2c - i], i = 0..L-1 (zero outside [0, L))
    hbar = jnp.flip(hp[..., 2 * c + 1 : 2 * c + 1 + L], axis=-1)
    w = _solve_hermitian(M, p_train[..., None] * jnp.conj(hbar))

    # unbias the signal-path gain (decision devices need unit scale).
    # |g0| is clamped to [1/2, 2]: a sane channel never needs more (an
    # 0.4 echo leaves h_c ~ 1), while a DEcohered fit (see below) can
    # collapse h_c and the raw 1/g0 then blew symbol buffers up 4x.
    g0 = jnp.sum(w * hbar, axis=-1)
    g0m = jnp.clip(jnp.abs(g0), 0.5, 2.0)
    g0 = jnp.where(jnp.abs(g0) > 1e-3, g0 / jnp.abs(g0), 1.0) * g0m
    w = w / g0[..., None]

    # model-sanity gate: when the LTI fit leaves most of the signal power
    # unexplained (sigma2 >~ 0.6 P only happens when the channel is
    # OUTSIDE the model class — e.g. a fast carrier ramp left by an
    # upstream carrier-fit branch slip decoheres every tap), no FIR taps
    # are trustworthy. Fall back to the identity: the per-segment payload
    # tracker downstream handles arbitrary smooth phase ramps, but only
    # if the equalizer has not scrambled the buffer first (measured r5:
    # 2.5 dB V27 frames with |syms| amplified 4x and EVM ~4 vs the 0.28
    # channel noise).
    bad = sigma2 > 0.6 * p_train
    return jnp.where(bad[..., None], delta, w).astype(jnp.complex64)


def _solve_hermitian(G: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve the Hermitian-PD complex system G w = rhs, batched, by
    conjugate gradients.

    CG is exact in <= L steps for an L-dimensional PD system (L = 8
    here), each step one small matvec + two reductions over the tap axis
    — a short, wide op chain XLA fuses well, where an unrolled 16x16
    real-embedded Cholesky is a ~700-op sequential dependency chain that
    runs latency-bound. Degenerate all-zero slots (masked detections) keep
    x = 0 via the guarded denominators."""
    L = G.shape[-1]
    x = jnp.zeros_like(rhs)
    r = rhs
    p = r
    rs = jnp.sum(jnp.abs(r) ** 2, axis=-1)
    for _ in range(L):
        gp = jnp.einsum("...ij,...j->...i", G, p)
        denom = jnp.maximum(jnp.real(jnp.sum(jnp.conj(p) * gp, axis=-1)), 1e-30)
        alpha = (rs / denom).astype(G.dtype)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * gp
        rs_new = jnp.sum(jnp.abs(r) ** 2, axis=-1)
        beta = (rs_new / jnp.maximum(rs, 1e-30)).astype(G.dtype)
        p = r + beta[..., None] * p
        rs = rs_new
    return x.astype(jnp.complex64)


def _eq_apply(w: jax.Array, syms: jax.Array, n_out: int | None = None) -> jax.Array:
    """Apply equalizer taps [..., L] to symbols [..., n]:
    z[n] = sum_t w[t] syms[n + c - t], same indexing as _eq_train.

    ``n_out`` limits the output length (the caller passes a context slice
    ``syms[..., :n_out + c]`` to equalize only a prefix region cheaply).

    Deliberately plain XLA: an 8-tap shifted-slice FMA fuses with its
    neighbours, where a kernel boundary would force the equalizer's input
    (the whole upstream symbol fusion) and output to materialize."""
    L = EQ_TAPS
    c = L // 2
    n = syms.shape[-1]
    if n_out is None:
        n_out = n
    lead = [(0, 0)] * (syms.ndim - 1)
    back = max(0, n_out + c - n)
    q = jnp.pad(syms, lead + [(L - 1 - c, back)])  # q[i] = syms[i - (L-1-c)]
    z = jnp.zeros(syms.shape[:-1] + (n_out,), dtype=jnp.complex64)
    for t in range(L):
        z = z + w[..., t, None] * q[..., L - 1 - t : L - 1 - t + n_out]
    return z


def _header_reference_symbols(hdr_bytes: jax.Array) -> jax.Array:
    """Re-encode decoded header bytes [..., 22] back to the TX's 180 QPSK
    header symbols — the EQ retraining reference. When the header CRC
    passed, this is bit-exactly the transmitted header."""
    bits = bitops.bytes_to_bits(hdr_bytes)  # [..., 176]
    pad = fs.HEADER_BITS_PADDED - fs.HEADER_BITS
    bits = jnp.concatenate(
        [bits, jnp.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype)], axis=-1
    )
    coded = golay2412().encode(bits)  # [..., 360]
    idx = modem.bits_to_indices(coded, 2)
    return modem.modulate(idx, fs.HEADER_MOD)


def _refine_carrier(syms: jax.Array) -> jax.Array:
    """Decision-free residual carrier correction from preamble + header.

    Previous design decided the header symbols first and measured the
    residual against those decisions — which folds (and biases toward
    zero) once the extrapolated phase error nears a decision boundary,
    exactly when correction matters most (observed as FEC-proof burst
    errors at 10 dB on long frames). Instead:

    - the *known* preamble (m-sequence QPSK, phy/frame_spec.py) gives an
      exact, ambiguity-free phase anchor phi_a at the preamble center;
    - the header (always QPSK, unknown bits) gives a Viterbi&Viterbi
      4th-power anchor: u = sum (r/|r|)^4 |r| has angle 4*phi + psi with
      no decision fold; its two half-sums also give a fold-free frequency
      estimate used only to *predict* the header-center phase well enough
      (<< 45 deg over the 122-symbol gap) to resolve the mod-(pi/2)
      branch of the anchor;
    - the final model is the two-point fit through (phi_a, phi_b): exact
      absolute phase, frequency from the longest clean baseline.

    Derotates the whole symbol stream; payload residuals are handled by
    _dd_phase_track's own V&V linear stage.
    """
    return _apply_carrier(syms, *_carrier_fit(syms))


def _carrier_fit(syms: jax.Array):
    """Fit the (phi_b, dphi) linear phase model from the preamble + header
    region ``syms[..., :h1]`` (see _refine_carrier for the estimator)."""
    from liquiddsp_tpu.ops import msequence

    h0 = fs.PREAMBLE_SYMS
    h1 = h0 + fs.HEADER_SYMS
    pre_ref = jnp.asarray(msequence.preamble_symbols())

    q = syms[..., :h0] * jnp.conj(pre_ref)
    q1 = jnp.sum(q[..., : h0 // 2], axis=-1)
    q2 = jnp.sum(q[..., h0 // 2 :], axis=-1)
    phi_a = jnp.angle(q1 + q2)  # exact phase @ preamble center
    n_a = (h0 - 1) / 2.0

    r_h = syms[..., h0:h1]
    u = (r_h / jnp.maximum(jnp.abs(r_h), 1e-12)) ** 4 * jnp.abs(r_h)
    half = fs.HEADER_SYMS // 2
    u1 = jnp.sum(u[..., :half], axis=-1)
    u2 = jnp.sum(u[..., half:], axis=-1)
    slope_h = jnp.angle(u2 * jnp.conj(u1)) / (4.0 * half)  # rad/sym, fold-free
    # psi: 4th-moment phase of the header constellation (pi for this QPSK)
    tab = modem.constellation(fs.HEADER_MOD)
    psi = float(np.angle(np.mean((tab / np.abs(tab)) ** 4 * np.abs(tab))))
    n_b = h0 + (fs.HEADER_SYMS - 1) / 2.0
    phi_b = jnp.angle((u1 + u2) * np.exp(-1j * psi)) / 4.0  # mod pi/2
    pred = phi_a + slope_h * (n_b - n_a)
    phi_b = phi_b + (jnp.pi / 2.0) * jnp.round((pred - phi_b) / (jnp.pi / 2.0))

    dphi = (phi_b - phi_a) / (n_b - n_a)
    return phi_b, dphi


def _apply_carrier(syms: jax.Array, phi_b: jax.Array, dphi: jax.Array) -> jax.Array:
    """Derotate by the fitted model, anchored at the header center n_b."""
    n_b = fs.PREAMBLE_SYMS + (fs.HEADER_SYMS - 1) / 2.0
    n = jnp.arange(syms.shape[-1], dtype=jnp.float32)
    corr = jnp.exp(-1j * (phi_b[..., None] + dphi[..., None] * (n - n_b)))
    return syms * corr


# ---------------------------------------------------------------------------
# common sync front-end (detect + symbols + header), then payload back-ends
# ---------------------------------------------------------------------------


def sync_common(
    x: jax.Array,
    n_syms: int,
    max_frames: int,
    threshold: float = 0.45,
    refine: bool = True,
    timing_bank: bool = True,
    equalize: bool = True,
    track_sfo: bool | str = "auto",
    det_override: Detections | None = None,
    fine: bool = True,
    return_peak_count: bool = False,
    return_hdr_ref: bool = False,
    ablate: tuple = (),
):
    """Config-independent RX front-end: [B, T] -> (det, refined symbols
    [B, K, n_syms], header fields, header EVM). ``n_syms`` is the static
    symbol-buffer size (the longest frame the caller expects).

    ``det_override`` replaces the detector stage with externally supplied
    candidates (genie-aided characterization, bench/fer_ladder.py);
    ``fine=False`` skips the per-frame fine-CFO refinement (used with exact
    genie dphi, where the refinement could only add estimation noise).

    One window extraction serves both the fine CFO estimate (from the
    preamble prefix of each frame window) and symbol recovery; the header
    is demod/decoded once, after decision-directed carrier refinement
    (the refined decode strictly dominates the raw one at any SNR where
    either works — pinned by tests/test_detection_sweep.py).

    The returned ``evm_lin`` [B, K] is the post-refinement header-symbol
    error-vector power — the framesyncstats_s EVM analog
    (lib/flex_rx_impl.cc:198) and the per-frame noise-variance estimate
    the payload soft demod consumes.
    """
    from liquiddsp_tpu.phy.detector import TEMPLATE_LEN, fine_cfo

    peak_count = None
    if det_override is not None:
        det = det_override
        if return_peak_count:
            peak_count = jnp.sum(det.mask.astype(jnp.int32), axis=-1)
    elif return_peak_count:
        det, peak_count = detect(
            x, max_frames, threshold, fine=False, return_count=True
        )
    else:
        det = detect(x, max_frames, threshold, fine=False)
    n_samples = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    if track_sfo == "auto":
        # sample-clock drift only walks off the symbol grid on long frames:
        # at 50 ppm the static per-frame tau is off by >0.1 sample beyond
        # ~2500 symbols. Short frames keep the cheaper static path.
        track_sfo = n_syms >= SFO_AUTO_SYMS
    win = extract_windows(x, det.start, n_samples)
    if fine:
        det = dataclasses.replace(
            det,
            dphi=det.dphi + fine_cfo(win[..., :TEMPLATE_LEN], det.dphi, det.tau),
        )
    if track_sfo:
        syms = _sfo_recover(win, det, n_syms)
    else:
        syms = symbols_from_windows(win, det, n_syms, timing_bank)

    h0, h1 = fs.PREAMBLE_SYMS, fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    if equalize:
        # Two-stage linear EQ (the flexframesync EQ stage, SURVEY.md
        # section 2.2): EQ1 trained on the 64 known preamble symbols gets
        # the header decodable under static ISI; once the header decodes,
        # EQ2 retrains on preamble + re-encoded header (244 known symbols,
        # ~6x lower coefficient noise) and re-equalizes the whole frame for
        # the payload. Invalid-header candidates keep the EQ1 taps.
        from liquiddsp_tpu.ops import msequence

        pre_ref = jnp.asarray(msequence.preamble_symbols())
        w1 = _eq_train(syms, pre_ref, static_ref=msequence.preamble_symbols())
        c = EQ_TAPS // 2
        hdr_region = _eq_apply(w1, syms[..., : h1 + c], n_out=h1)
        raw_region = syms[..., :h1]
        # absolute phase at the preamble tail of the EQ1 stream (known
        # symbols — no modular ambiguity): anchors the tracked header
        # branch independently of the linear carrier fit, which is the
        # component that breaks under sub-frame fading
        qp1 = jnp.sum(
            hdr_region[..., h0 - 32 : h0 - 16] * jnp.conj(pre_ref[-32:-16]), axis=-1
        )
        qp2 = jnp.sum(
            hdr_region[..., h0 - 16 : h0] * jnp.conj(pre_ref[-16:]), axis=-1
        )
        slope_pre = jnp.angle(qp2 * jnp.conj(qp1)) / 16.0  # rad/symbol
        # extrapolate to the center of the first tracked header segment
        # (seg=18): 8 symbols from the qp2 center to h0, +9 into the header
        anchor_pre = jnp.angle(qp2) + slope_pre * (8.0 + 9.0)
        hdr_pre_fit = hdr_region  # EQ1 stream before any carrier model
        if refine:
            # Fit the carrier model per branch: the raw branch's fit (and
            # thus its header decode) is bit-identical to the equalize=False
            # path; the EQ branch fits on ISI-corrected symbols.
            # (``ablate`` tokens are measurement-only hooks for
            # tools/profile_rx.py fused-diff timings — never set in
            # production; each drops exactly one sub-stage.)
            fit_eq = _carrier_fit(hdr_region)
            fit_raw = fit_eq if "fit2" in ablate else _carrier_fit(syms)
            hdr_region = _apply_carrier(hdr_region, *fit_eq)
            raw_region = _apply_carrier(raw_region, *fit_raw)
        # Decode the header from BOTH the equalized and the raw (refined)
        # streams and accept either: EQ1's coefficient noise (61 training
        # equations) costs ~0.5 dB on a clean channel, which must never
        # lose a header the unequalized path would have decoded. Prefer
        # the equalized decode when both pass (ISI channels).
        # third branch: per-segment tracked header (the linear carrier
        # model breaks when gain/phase wander WITHIN the header — the
        # sub-frame-coherence fading regime; measured r4 as a ~40% header
        # outage floor on the tc0.5 rows). _dd_phase_track's unwrapped
        # V&V trajectory + DD complex-gain follows the wander, running on
        # the pre-fit EQ1 stream with the absolute preamble anchor (so a
        # fading-corrupted global fit cannot slip the whole branch); CRC24
        # arbitrates, so a static channel can only gain (accept any pass).
        hdr_trk = (
            hdr_pre_fit[..., h0:h1]
            if "trk" in ablate
            else _dd_phase_track(
                hdr_pre_fit[..., h0:h1], fs.HEADER_MOD, seg=18,
                anchor=anchor_pre, anchor_slope=slope_pre,
            )
        )
        # ONE decode for all three branches (decode_header_multi) instead
        # of three separate calls
        if "hdr1" in ablate:
            rlist = [hdr_region[..., h0:h1]]
            je, jr, jt = 0, 0, 0
        else:
            rlist = [hdr_region[..., h0:h1], raw_region[..., h0:h1], hdr_trk]
            je, jr, jt = 0, 1, 2
        (v3, u3, pl3, m3, i3, o3), hb3 = decode_header_multi(rlist)
        v_eq, v_raw, v_trk = v3[..., je], v3[..., jr], v3[..., jt]
        u_eq, u_raw, u_trk = u3[..., je, :], u3[..., jr, :], u3[..., jt, :]
        pl_eq, pl_raw, pl_trk = pl3[..., je], pl3[..., jr], pl3[..., jt]
        m_eq, m_raw, m_trk = m3[..., je], m3[..., jr], m3[..., jt]
        i_eq, i_raw, i_trk = i3[..., je], i3[..., jr], i3[..., jt]
        o_eq, o_raw, o_trk = o3[..., je], o3[..., jr], o3[..., jt]
        hb_eq, hb_raw, hb_trk = hb3[..., je, :], hb3[..., jr, :], hb3[..., jt, :]
        hdr_valid = v_eq | v_raw | v_trk
        pick = v_eq  # prefer the equalized decode, then raw, then tracked
        p_raw = (~v_eq) & v_raw
        pick3 = lambda a, b, c: jnp.where(pick, a, jnp.where(p_raw, b, c))
        pick3v = lambda a, b, c: jnp.where(
            pick[..., None], a, jnp.where(p_raw[..., None], b, c)
        )
        user = pick3v(u_eq, u_raw, u_trk)
        plen = pick3(pl_eq, pl_raw, pl_trk)
        mod = pick3(m_eq, m_raw, m_trk)
        inner = pick3(i_eq, i_raw, i_trk)
        outer = pick3(o_eq, o_raw, o_trk)
        hdr_bytes = pick3v(hb_eq, hb_raw, hb_trk)
        if refine:
            # derotate the full stream with the winning branch's fit (the
            # tracked branch rides the EQ branch's fit)
            use_eq_fit = pick | (~p_raw)
            phi_b = jnp.where(use_eq_fit, fit_eq[0], fit_raw[0])
            dphi = jnp.where(use_eq_fit, fit_eq[1], fit_raw[1])
            syms = _apply_carrier(syms, phi_b, dphi)
        hdr_tx_ref = _header_reference_symbols(hdr_bytes)  # [B, K, 180]
        refs = jnp.concatenate(
            [jnp.broadcast_to(pre_ref, hdr_tx_ref.shape[:-1] + (h0,)), hdr_tx_ref],
            axis=-1,
        )
        if "eq2" in ablate:
            w = w1
        else:
            w2 = _eq_train(syms, refs)
            w = jnp.where(hdr_valid[..., None], w2, w1)
        if "apply" not in ablate:
            syms = _eq_apply(w, syms)
    else:
        if refine:
            syms = _refine_carrier(syms)
        hdr_valid, user, plen, mod, inner, outer = decode_header(syms[..., h0:h1])
        hdr_tx_ref = None

    # header EVM from the refined symbols' own hard decisions
    hdr_idx = modem.demod_hard(syms[..., h0:h1], fs.HEADER_MOD)
    hdr_dec_ref = modem.modulate(hdr_idx, fs.HEADER_MOD)
    evm_lin = jnp.mean(jnp.abs(syms[..., h0:h1] - hdr_dec_ref) ** 2, axis=-1)

    out = (det, syms, (hdr_valid, user, plen, mod, inner, outer), evm_lin)
    if return_peak_count:
        out = out + (peak_count,)
    if return_hdr_ref:
        out = out + (hdr_tx_ref,)
    return out


def _dd_phase_track(
    pay: jax.Array,
    mod: int,
    seg: int = 64,
    iters: int = 2,
    anchor: jax.Array | float = 0.0,
    anchor_slope: jax.Array | float = 0.0,
    return_weight: bool = False,
) -> jax.Array:
    """Decision-directed segment-wise carrier tracking over payload symbols.

    The header-based refinement (_refine_carrier) extrapolates a linear
    phase model far beyond the header; residual CFO estimation error
    accumulates over long payloads (thousands of symbols for low-rate
    configs) and breaks coherent demod. liquid's flexframesync tracks the
    carrier with a per-symbol PLL through the whole frame (SURVEY.md
    section 2.2 AGC/NCO/symbol-sync row); a sequential PLL is a poor fit
    for a batched accelerator, so this applies the block-dense equivalent: split the payload
    into ``seg``-symbol segments and estimate each segment's residual phase
    from its own hard decisions (sum of r*conj(decision)).

    A DD estimate is only observable modulo the constellation's rotational
    symmetry 2*pi/m, and is *biased toward zero* near the decision
    boundaries (the S-curve folds): once the extrapolated phase error
    approaches half the symmetry angle, decision-directed corrections lock
    to the wrong rotation (a cycle slip relabeling every later symbol —
    burst errors no FEC survives). When slips are plausible, a
    decision-free first pass runs: per segment, the Viterbi&Viterbi
    m-th-power statistic u_i = sum (r/|r|)^m |r| has angle m*theta_i +
    psi_m + modulation self-noise (psi_m the constellation's m-th-moment
    phase, a compile-time constant), with no fold and no bias. A linear
    trajectory (residual CFO + offset) is fit through the u_i — slope from
    the average adjacent-segment increment (psi_m cancels), intercept from
    the detrended sum — and applied as a per-symbol ramp. Valid while the
    drift per segment stays under pi/m, far above any CFO error the
    decision-free _refine_carrier lets through. The corrected residual is
    then small enough for plain per-segment DD cleanup passes (unbiased
    away from boundaries).

    The V&V stage is gated at compile time on actual slip risk: the worst
    plausible post-refine drift over this payload must reach an
    appreciable fraction of the symmetry angle. QAM/ASK constellations
    (m-th moment < 1) additionally require enough segments to average the
    estimator's modulation self-noise; a short dense-QAM payload can
    neither slip nor tolerate V&V noise, so it takes the pure DD path.
    Differential schemes are returned unchanged (immune by construction).
    """
    if modem.is_differential(mod):
        if return_weight:
            return pay, jnp.ones(pay.shape, jnp.float32)
        return pay
    sym_rot = modem.rotational_symmetry(mod)
    m = int(round(2 * np.pi / sym_rot))
    table_np = modem.constellation(mod)
    unit = table_np / np.maximum(np.abs(table_np), 1e-12)
    moment = np.mean(unit**m * np.abs(table_np))
    psi = float(np.angle(moment))
    n = pay.shape[-1]
    nseg = -(-n // seg)
    pad = nseg * seg - n
    table = jnp.asarray(table_np)
    lead_shape = [(0, 0)] * (pay.ndim - 1)

    # slip risk: 5-sigma residual slope after the decision-free refine
    # (~2.7e-4 rad/sym sigma at the lowest workable SNR) over the payload
    drift_5sigma = 1.4e-3 * n
    # weak-moment (QAM/ASK) V&V quality: the m-th-power modulation
    # self-noise of the GLOBAL fit scales as 1/(|moment| sqrt(n)) — even
    # noiseless. Require |moment| sqrt(n) >= 3 or the fit injects more
    # phase error than it removes (cross-QAM32 at 197 symbols measured
    # 1.25: a noiseless roundtrip FAILED with the fit enabled).
    use_vv = (
        nseg >= 2
        and drift_5sigma > sym_rot / 8
        and (abs(moment) > 0.9 or abs(moment) * np.sqrt(n) >= 3.0)
    )

    p = jnp.pad(pay, lead_shape + [(0, pad)])
    p = p.reshape(pay.shape[:-1] + (nseg, seg))

    if use_vv:
        # pass 1: decision-free per-segment V&V phase trajectory, unwrapped
        # across segments by continuity. Round 1-4 fit a LINEAR model
        # (offset + slope) through the segment statistics — right for a
        # residual-CFO ramp, wrong for the nonlinear phase wander of
        # sub-frame-coherence fading (the tc0.5 scope boundary). The trajectory form subsumes the line:
        # theta_i = angle(u_i e^{-j psi})/m is fold-free mod 2pi/m per
        # segment; the branch of segment i is resolved to the value nearest
        # the unwrapped theta_{i-1} (valid while the true phase moves
        # < pi/m per segment — ~2x the headroom of the old slope clip),
        # anchored at segment 0 by the carrier fit's ~zero residual. The
        # per-symbol correction interpolates linearly between segment
        # centers, so smooth fading is tracked through the whole frame
        # instead of averaged into one slope.
        r_unit = p / jnp.maximum(jnp.abs(p), 1e-12)
        u = jnp.sum(r_unit**m * jnp.abs(p), axis=-1)  # [..., nseg]
        th_raw = jnp.angle(u * np.exp(-1j * psi)) / m  # (-pi/m, pi/m]
        period = sym_rot  # = 2*pi/m
        # per-segment estimator quality ~ |moment| * sqrt(seg): the
        # trajectory chain needs each segment's theta individually (PSK
        # family, |moment| ~ 1); weak-moment QAM/ASK segments are too
        # noisy individually and take the 2-parameter linear fit below,
        # which averages the self-noise across ALL segments
        if abs(moment) <= 0.6:
            slope = (
                jnp.angle(jnp.sum(u[..., 1:] * jnp.conj(u[..., :-1]), axis=-1)) / m
            )  # rad per segment
            slope = jnp.clip(slope, -sym_rot / 4, sym_rot / 4)
            detrend = jnp.exp(-1j * m * slope[..., None] * jnp.arange(nseg))
            a = (jnp.angle(jnp.sum(u * detrend, axis=-1) * np.exp(-1j * psi))) / m
            t_idx = jnp.arange(nseg * seg, dtype=jnp.float32)
            phi = a[..., None] + (slope[..., None] / seg) * (
                t_idx - (seg - 1) / 2.0
            )
            flat = p.reshape(pay.shape[:-1] + (nseg * seg,)) * jnp.exp(-1j * phi)
            n_dd = max(iters - 1, 1)
            return _dd_gain_passes(flat, pay, mod, table, nseg, seg, n, n_dd,
                                   return_weight=return_weight)
        # ``anchor``: external absolute-phase prediction for the CENTER of
        # segment 0 (e.g. extrapolated from the header tail,
        # framesync_fixed) and ``anchor_slope`` its rad/symbol rate —
        # under sub-frame fading the phase at the payload start is neither
        # small nor slowly-moving, so "branch nearest 0" (or nearest a
        # stale anchor) slips whole frames. Branch chaining is
        # slope-predictive AND confidence-gated: segment i resolves its
        # fold against th_{prev} + slope (a segment-granular first-order
        # PLL — the drift consumes the +-period/2 headroom otherwise),
        # with the slope updated as an EMA over confident increments and
        # the reference frozen across deep-fade segments (their theta is
        # noise and must not derail the chain). Branch decisions use a
        # slope-detrended 1-2-1 smoothing of the neighboring V&V
        # statistics (coherent in the m*theta domain once the running
        # slope is removed): ~sqrt(2) lower fold-decision noise, which is
        # what keeps the chain slip-free at the coded rows' low-SNR
        # operating points (V27@2.5dB union-bound anchor) without giving
        # up per-segment agility under fading.
        conf = jnp.abs(u)
        thr = 0.35 * jnp.median(conf, axis=-1, keepdims=True)
        slope = jnp.broadcast_to(
            jnp.asarray(anchor_slope, jnp.float32) * seg, th_raw[..., 0].shape
        )  # rad per segment
        half_p = period / 2.0

        def th_at(i, slope):
            us = u[..., i]
            rot = jnp.exp(1j * m * slope)
            if i > 0:
                us = us + 0.5 * u[..., i - 1] * rot
            if i + 1 < nseg:
                us = us + 0.5 * u[..., i + 1] * jnp.conj(rot)
            return jnp.angle(us * np.exp(-1j * psi)) / m

        th_0 = th_at(0, slope)
        b0 = jnp.round((th_0 - anchor) / period)
        th0 = th_0 - b0 * period
        th = [th0]
        good = conf[..., 0] > thr[..., 0]
        ref = jnp.where(good, th0, jnp.broadcast_to(anchor, th0.shape))
        for i in range(1, nseg):
            pred = ref + slope
            th_raw_i = th_at(i, slope)
            b = jnp.round((th_raw_i - pred) / period)
            th_i = th_raw_i - b * period
            th.append(th_i)
            good_i = conf[..., i] > thr[..., 0]
            inc = jnp.clip(th_i - ref, -1.2 * half_p, 1.2 * half_p)
            both = good & good_i
            slope = jnp.where(both, 0.5 * slope + 0.5 * inc, slope)
            ref = jnp.where(good_i, th_i, ref + slope)
            good = good_i
        th = jnp.stack(th, axis=-1)  # [..., nseg] unwrapped
        # piecewise-linear interpolation between segment centers (static
        # gather indices — no data-dependent control flow)
        t_pos = (np.arange(nseg * seg, dtype=np.float32) - (seg - 1) / 2.0) / seg
        j_lo = np.clip(np.floor(t_pos).astype(np.int32), 0, nseg - 2)
        fr = jnp.asarray(np.clip(t_pos - j_lo, 0.0, 1.0), dtype=jnp.float32)
        phi = th[..., j_lo] * (1.0 - fr) + th[..., j_lo + 1] * fr
        flat = p.reshape(pay.shape[:-1] + (nseg * seg,)) * jnp.exp(-1j * phi)
        n_dd = max(iters - 1, 1)
    else:
        flat = p.reshape(pay.shape[:-1] + (nseg * seg,))
        n_dd = iters

    return _dd_gain_passes(flat, pay, mod, table, nseg, seg, n, n_dd,
                            return_weight=return_weight)


def _dd_gain_passes(flat, pay, mod, table, nseg, seg, n, n_dd, dd_seg=None,
                    return_weight=False):
    """Independent per-segment decision-directed COMPLEX GAIN passes
    (residual assumed well inside the decision regions).

    ``dd_seg``: segment size for these cleanup passes (defaults to the
    V&V grid ``seg``); a coarser DD grid halves the per-segment estimate
    noise at the coded rows' low-SNR operating points while the V&V stage
    has already removed the fast wander.

    The LS gain g = <p, d>/<d, d> corrects phase AND amplitude — a
    per-segment flat-fading tracker: amplitude matters for the QAM
    decision grids under fading/ramps (r4's phase-only rotation left the
    grid scaled by the faded gain). |g| is clamped to [1/4, 4] so a
    deep-null segment (garbage estimate) cannot blow up the symbols.
    The tail segment is zero-padded: decisions OF the pad are nonzero
    constellation points, so the gain denominator counts only real
    symbols (an unmasked pad collapsed |g| and the clamp then scaled the
    tail's real symbols 4x — QAM frames died; caught by FER_LADDER).
    """
    if dd_seg and dd_seg != seg:
        seg = dd_seg
        nseg = -(-n // seg)
        lead = [(0, 0)] * (flat.ndim - 1)
        flat = jnp.pad(flat[..., :n], lead + [(0, nseg * seg - n)])
    valid = jnp.asarray(
        (np.arange(nseg * seg) < n).reshape(nseg, seg).astype(np.float32)
    )
    wmag = None
    for _ in range(n_dd):
        p = flat.reshape(pay.shape[:-1] + (nseg, seg))
        idx = modem.demod_hard(p, mod)
        d = table[idx] * valid
        e = jnp.sum(p * jnp.conj(d), axis=-1)  # [..., nseg]
        pd = jnp.maximum(jnp.sum(jnp.abs(d) ** 2, axis=-1), 1e-12)
        g = e / pd
        mag = jnp.clip(jnp.abs(g), 0.25, 4.0)
        g = jnp.where(jnp.abs(g) > 1e-6, g / jnp.abs(g), 1.0) * mag
        flat = (p / g[..., None]).reshape(pay.shape[:-1] + (nseg * seg,))
        if return_weight:
            # cumulative UNCLAMPED |g| (floored only to keep 1/w^2 finite):
            # the correction must not blow up a deep-null segment (clamp
            # above), but the LLR weight SHOULD collapse it toward an
            # erasure — post-normalization noise there is up by 1/|g|^2
            m_raw = jnp.clip(jnp.abs(e) / pd, 1e-3, 4.0)
            wmag = m_raw if wmag is None else wmag * m_raw
    if return_weight:
        if wmag is None:
            w_sym = jnp.ones(pay.shape[:-1] + (n,), jnp.float32)
        else:
            w_sym = jnp.repeat(wmag, seg, axis=-1)[..., :n]
        return flat[..., :n], w_sym
    return flat[..., :n]


def decode_payload_symbols(
    syms: jax.Array,
    cfg: FrameConfig,
    track: bool = True,
    noise_var: jax.Array | float | None = None,
    anchor: jax.Array | None = None,
    anchor_slope: jax.Array | float = 0.0,
    slip_retry: bool = False,
):
    """Static-config payload back-end: symbols [.., n_syms >= frame_syms] ->
    (payload bytes [..., payload_len], crc_ok bool[...]).

    ``noise_var``: per-frame noise-variance estimate for LLR scaling —
    typically the header EVM from sync_common (framesyncstats EVM analog,
    lib/flex_rx_impl.cc:198); scalar or [...] matching syms' leading dims.
    The max-log Viterbi path metric is invariant to a uniform LLR scale, so
    this only matters for future soft-combining consumers, but the estimate
    is the principled one (the old constant 0.1 was a tuning point).

    ``anchor``: absolute phase at the payload start (symbol h1) for the
    payload tracker's segment-0 branch, with ``anchor_slope`` its
    rad/symbol rate (see framesync_fixed, which reconstructs both from the
    re-encoded decoded header — exact and ambiguity-free whenever the
    header decoded). Without it, a V&V estimate of the header tail is used
    (fold-free only while the residual there is < pi/4).
    """
    spec = fs.FrameSpec(cfg)
    h1 = fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    pay = syms[..., h1 : h1 + spec.payload_syms]
    if track:
        if anchor is None:
            # header-tail V&V anchor (always QPSK, m=4): chains the payload
            # trajectory to the last known-good phase instead of assuming
            # the carrier fit still holds at the payload start (it does
            # not under sub-frame-coherence fading)
            tail = syms[..., h1 - 40 : h1]
            ut = jnp.sum(
                (tail / jnp.maximum(jnp.abs(tail), 1e-12)) ** 4 * jnp.abs(tail),
                axis=-1,
            )
            tab4 = modem.constellation(fs.HEADER_MOD)
            psi4 = float(
                np.angle(np.mean((tab4 / np.abs(tab4)) ** 4 * np.abs(tab4)))
            )
            anchor = jnp.angle(ut * np.exp(-1j * psi4)) / 4.0
        # Pre-derotate the payload by the measured header-exit line
        # (anchor phase + slope): the residual the tracker sees then
        # starts at ~zero phase and ~zero slope, so its fold-resolution
        # chain never has to absorb a large handoff (a carrier-fit pi/2
        # branch slip leaves a pi/2-per-152-symbols ramp; handing that to
        # the chain as an initial condition was measurably fragile at the
        # coded rows' 2.5 dB operating point). Slope noise extrapolates
        # to ~0.35 rad at the end of a 268-symbol payload worst-case —
        # well inside the chain's per-segment headroom, and the V&V
        # estimates are unbiased so it is tracked right back out.
        t_rel = jnp.arange(pay.shape[-1], dtype=jnp.float32)
        line = anchor[..., None] + jnp.asarray(anchor_slope, jnp.float32)[
            ..., None
        ] * t_rel
        pay = pay * jnp.exp(-1j * line)
        # Segment size 32: fine enough that sub-frame fading (coherence
        # down to ~0.5 frame) moves the phase well under pi/m between
        # segment centers, while the per-segment V&V estimate stays usable
        # at the coded rows' low-SNR operating points (seg=16 measured a
        # further ~0.05 FER gain on the tc0.5 row at 20 dB but broke the
        # V27 union-bound anchor at 2.5 dB via branch slips — robustness
        # across the SNR range wins). AWGN cost vs seg=64: nil
        # (FER_LADDER).
        pay, gmag = _dd_phase_track(pay, cfg.modulation, seg=32,
                                    return_weight=True)
    else:
        gmag = None
    if noise_var is None:
        noise_var = 0.1
    nv = jnp.maximum(jnp.asarray(noise_var, jnp.float32), 1e-4)
    if nv.ndim:
        nv = nv[..., None]  # broadcast over the per-symbol axis
    if gmag is not None:
        # Fading-aware LLR scaling: the gain passes DIVIDED each segment
        # by its estimated complex gain, so post-normalization noise is up
        # by 1/|g|^2 there — a faded segment must speak into the Viterbi /
        # block decoders with proportionally less confidence (uniform nv
        # fed deep fades in at full confidence and erased the coding gain
        # under sub-frame fading: coded tc0.5 FER matched UNCODED before
        # this). |g|~1 on static channels, so AWGN rows are untouched.
        nv = nv / jnp.square(gmag)
    if (slip_retry and gmag is not None
            and not modem.is_differential(cfg.modulation)):
        # Branch-slip retry (sub-frame fading): across a deep fade the
        # trajectory chain's fold decision runs blind (confidence-frozen
        # reference) -- if the true phase moved more than half a symmetry
        # period during the fade, every post-fade segment comes out
        # rotated by exactly one symmetry period: CONFIDENTLY wrong
        # symbols that no LLR weighting can save (the DD gain pass is
        # rotation-equivariant, so it cannot see the slip either). The
        # slip point is the least-confident segment (the fade minimum,
        # read off the gain weights), so decode THREE candidates -- as
        # tracked, and with +-one period applied from the boundary after
        # that segment -- and let CRC-24 arbitrate. Fixed 3x payload-
        # decode cost; off by default on the throughput path.
        period = modem.rotational_symmetry(cfg.modulation)
        seg = 32
        n = pay.shape[-1]
        conf = gmag[..., ::seg]  # [..., nseg] per-segment weight
        js = jnp.argmin(conf, axis=-1)  # [...] fade minimum
        t_idx = jnp.arange(n)
        mask = (t_idx >= ((js[..., None] + 1) * seg)).astype(jnp.float32)
        rots = jnp.stack([jnp.zeros_like(mask), mask, -mask], axis=-2)
        pay = pay[..., None, :] * jnp.exp(1j * period * rots)  # [..., 3, n]
        nv = nv[..., None, :] if nv.ndim else nv
    else:
        rots = None
    llr = modem.demod_soft_bits(pay, cfg.modulation, nv)
    llr = llr[..., : spec.inner_bits]  # drop modulation pad bits
    inv = jnp.asarray(fs.interleave_inv(spec.inner_bits))
    llr = llr[..., inv]
    obits = registry.inner_decode(llr, spec.outer_bits, cfg.inner_code)
    msg = registry.outer_decode(obits, spec.payload_msg_bytes, cfg.outer_code)
    crc_ok = crc.crc24_check(msg)
    if rots is not None:
        # first CRC pass wins (candidate 0 = as-tracked, so a static
        # channel always keeps its original decode)
        pick = jnp.argmax(crc_ok, axis=-1)  # [...]
        msg = jnp.take_along_axis(
            msg, pick[..., None, None].astype(jnp.int32), axis=-2
        )[..., 0, :]
        crc_ok = jnp.any(crc_ok, axis=-1)
    return msg[..., : cfg.payload_len], crc_ok


def framesync_fixed(
    x: jax.Array,
    cfg: FrameConfig,
    max_frames: int,
    threshold: float = 0.45,
    refine: bool = True,
    timing_bank: bool = True,
    equalize: bool = True,
    track_sfo: bool | str = "auto",
    det_override: Detections | None = None,
    fine: bool = True,
    track: bool = True,
    noise_var_override: jax.Array | float | None = None,
    return_peak_count: bool = False,
    slip_retry: bool = False,
    ablate: tuple = (),
):
    """Full RX for blocks known to carry frames of one static config.

    [B, T] samples -> FrameResults with [B, K] slots. Frames straddling the
    block end are not decoded (handled by the streaming runtime's overlap
    carry — runtime/stream.py).

    The genie hooks (``det_override``/``fine``/``track``/
    ``noise_var_override``) exist for stage-attribution characterization
    (bench/fer_ladder.py) — production callers leave them at defaults.
    """
    spec = fs.FrameSpec(cfg)
    sc = sync_common(
        x, spec.frame_syms, max_frames, threshold, refine, timing_bank,
        equalize, track_sfo, det_override=det_override, fine=fine,
        return_peak_count=return_peak_count, return_hdr_ref=True,
        ablate=ablate,
    )
    det, syms, (hdr_valid, user, plen, mod, inner, outer), evm_lin = sc[:4]
    peak_count = sc[4] if return_peak_count else None
    hdr_ref_sc = sc[-1]

    # payload: static config path, LLRs scaled by the per-frame EVM-derived
    # noise variance (framesyncstats analog; lib/flex_rx_impl.cc:198)
    nv = evm_lin if noise_var_override is None else noise_var_override

    # absolute payload-tracker anchor: rebuild the TX header symbols from
    # the DECODED header fields (user + len + config + CRC24 -> Golay ->
    # QPSK — bit-exact when header_valid) and correlate against the header
    # tail. Exact and fold-free, unlike a V&V tail estimate, so a fading
    # frame whose phase wandered > pi/4 by the payload start cannot slip
    # the whole payload trajectory. Garbage when the header failed, where
    # the payload is moot anyway.
    h1 = fs.PREAMBLE_SYMS + fs.HEADER_SYMS
    if hdr_ref_sc is not None:
        # the equalize path already re-encoded the decoded header for EQ2
        # retraining — reuse it (one fewer Golay encode per block)
        hdr_ref = hdr_ref_sc
    else:
        proto = jnp.stack(
            [(plen >> 8) & 0xFF, plen & 0xFF, mod, inner, outer], axis=-1
        ).astype(jnp.uint8)
        hdr22 = crc.crc24_append(jnp.concatenate([user, proto], axis=-1))
        hdr_ref = _header_reference_symbols(hdr22)
    # slope from the two 90-symbol header halves (long baseline: a 20-sym
    # baseline's slope noise at 2.5 dB is ~0.19 rad/segment and the
    # tracker chain trusting it SLIPPED frames that were fine pre-track);
    # phase from the last 20 symbols (agile under fading). All absolute
    # correlations against the re-encoded header — no modular ambiguity.
    h0_ = h1 - 180
    u1 = jnp.sum(
        syms[..., h0_ : h0_ + 90] * jnp.conj(hdr_ref[..., :90]), axis=-1
    )
    u2 = jnp.sum(syms[..., h0_ + 90 : h1] * jnp.conj(hdr_ref[..., 90:]), axis=-1)
    a_slope = jnp.angle(u2 * jnp.conj(u1)) / 90.0  # rad/symbol
    a_slope = jnp.clip(a_slope, -0.025, 0.025)  # ramp sanity (max residual
    # from a carrier-fit branch slip ~0.0103; fading ~0.02)
    q2 = jnp.sum(syms[..., h1 - 20 : h1] * jnp.conj(hdr_ref[..., -20:]), axis=-1)
    anchor = jnp.angle(q2) + a_slope * 10.0  # extrapolated to h1

    payload, crc_ok = decode_payload_symbols(
        syms, cfg, track=track, noise_var=nv, anchor=anchor,
        anchor_slope=a_slope, slip_retry=slip_retry
    )
    pay_valid = crc_ok & hdr_valid

    evm = 10.0 * jnp.log10(jnp.maximum(evm_lin, 1e-12))
    rssi = 20.0 * jnp.log10(jnp.maximum(det.gamma, 1e-12))

    cfg_match = (
        (mod == cfg.modulation)
        & (inner == cfg.inner_code)
        & (outer == cfg.outer_code)
        & (plen == cfg.payload_len)
    )
    hdr_ok = hdr_valid & det.mask
    res = FrameResults(
        mask=det.mask,
        header_valid=hdr_ok,
        payload_valid=pay_valid & cfg_match & det.mask,
        modulation=mod,
        inner_code=inner,
        outer_code=outer,
        payload_len=plen,
        header_user=user,
        payload=payload,
        symbols=syms,
        evm=evm,
        rssi=rssi,
        cfo=det.dphi,
        start=det.start,
    )
    if return_peak_count:
        return res, peak_count
    return res
