"""K=7 convolutional code with puncturing + vectorized Viterbi decoding.

The reference's inner-FEC family (liquid enums at lib/flex_tx_impl.cc:119-147):
CONV_V27 (rate 1/2, constraint length 7) and punctured variants
V27P{23,45,56,67,78} with rates 2/3, 4/5, 5/6, 6/7, 7/8.

Framework spec:
- generator polynomials 0o133, 0o171 (the standard K=7 pair), MSB = oldest bit.
- encoder register ``reg = (state << 1) | u``; output bits
  c0 = parity(reg & G0), c1 = parity(reg & G1); next state = reg & 0x3F.
- terminated trellis: 6 zero tail bits appended, final state 0.
- puncturing: periodic keep-masks over the (c0, c1) streams (patterns below,
  framework-defined); depuncturing inserts zero-LLR erasures.

Array mapping: the encoder computes each output bit as a fixed XOR of <=7
shifted message bits (no scan). The plain Viterbi decoder is a
``lax.scan`` over symbols whose per-step add-compare-select is vectorized
over the 64 states and the batch dimension; the traceback is a second
reversed scan over the stored decision bits. On a GPU both loops run
inside one Pallas kernel instead (kernels/viterbi.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.kernels import choose

G0 = 0o133  # 0b1011011
G1 = 0o171  # 0b1111001
K = 7
NSTATES = 64  # 2**(K-1)
NTAIL = K - 1

# puncture keep-masks per (inner_code - 1): ([c0 period], [c1 period])
# index 1 = V27 (no puncturing). Patterns are framework-defined; DVB-style
# for 2/3, 5/6, 7/8, keep-first for 4/5, 6/7.
PUNCTURE_PATTERNS: dict[int, tuple[tuple[int, ...], tuple[int, ...]]] = {
    1: ((1,), (1,)),  # rate 1/2
    2: ((1, 1), (1, 0)),  # rate 2/3
    3: ((1, 1, 1, 1), (1, 0, 0, 0)),  # rate 4/5
    4: ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0)),  # rate 5/6
    5: ((1, 1, 1, 1, 1, 1), (1, 0, 0, 0, 0, 0)),  # rate 6/7
    6: ((1, 0, 0, 0, 1, 0, 1), (1, 1, 1, 1, 0, 1, 0)),  # rate 7/8
}


def _parity_table() -> np.ndarray:
    t = np.zeros(128, dtype=np.int8)
    for v in range(128):
        t[v] = bin(v).count("1") & 1
    return t


_PAR = _parity_table()


@functools.lru_cache(maxsize=None)
def _trellis_tables():
    """Per-(state, input) output bits and transition tables, numpy constants.

    Returns (out0[64,2], out1[64,2]) int8: expected coded bits for leaving
    ``state`` with input u.
    """
    out0 = np.zeros((NSTATES, 2), dtype=np.int8)
    out1 = np.zeros((NSTATES, 2), dtype=np.int8)
    for s in range(NSTATES):
        for u in range(2):
            reg = ((s << 1) | u) & 0x7F
            out0[s, u] = _PAR[reg & G0]
            out1[s, u] = _PAR[reg & G1]
    return out0, out1


def num_coded_bits(nbits: int, inner_code: int) -> int:
    """Coded length (post-puncturing) for ``nbits`` message bits (+6 tail)."""
    if inner_code == 0:
        return nbits
    p0, p1 = PUNCTURE_PATTERNS[inner_code]
    period = len(p0)
    total_steps = nbits + NTAIL
    keep_per_period = sum(p0) + sum(p1)
    full, rem = divmod(total_steps, period)
    n = full * keep_per_period
    for i in range(rem):
        n += p0[i] + p1[i]
    return n


def _keep_mask(total_steps: int, inner_code: int) -> np.ndarray:
    """Interleaved keep mask [total_steps, 2] for (c0, c1)."""
    p0, p1 = PUNCTURE_PATTERNS[inner_code]
    period = len(p0)
    reps = -(-total_steps // period)
    m0 = np.tile(np.asarray(p0, dtype=bool), reps)[:total_steps]
    m1 = np.tile(np.asarray(p1, dtype=bool), reps)[:total_steps]
    return np.stack([m0, m1], axis=1)


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def encode_host(bits: np.ndarray, inner_code: int) -> np.ndarray:
    """[nbits] uint8 -> punctured coded bits (numpy oracle)."""
    if inner_code == 0:
        return bits.astype(np.uint8)
    msg = np.concatenate([bits, np.zeros(NTAIL, dtype=bits.dtype)])
    state = 0
    coded = []
    for u in msg:
        reg = ((state << 1) | int(u)) & 0x7F
        coded.append((_PAR[reg & G0], _PAR[reg & G1]))
        state = reg & 0x3F
    coded = np.asarray(coded, dtype=np.uint8)  # [steps, 2]
    mask = _keep_mask(len(msg), inner_code)
    return coded[mask]


# ---------------------------------------------------------------------------
# jax encode
# ---------------------------------------------------------------------------


def encode(bits: jax.Array, inner_code: int) -> jax.Array:
    """bits [..., nbits] int8 -> coded [..., num_coded_bits] int8.

    ``inner_code`` is static. Encoding c_i[t] = XOR of message bits in a
    7-tap window — computed with 7 shifted XOR terms (no scan).
    """
    if inner_code == 0:
        return bits.astype(jnp.int8)
    nbits = bits.shape[-1]
    steps = nbits + NTAIL
    msg = jnp.concatenate(
        [bits, jnp.zeros(bits.shape[:-1] + (NTAIL,), dtype=bits.dtype)], axis=-1
    ).astype(jnp.int32)
    # padded[t] window: u_{t-6}..u_t ; prepend 6 zeros for initial state
    padded = jnp.concatenate(
        [jnp.zeros(bits.shape[:-1] + (NTAIL,), dtype=jnp.int32), msg], axis=-1
    )

    def code_bits(poly: int) -> jax.Array:
        acc = jnp.zeros(bits.shape[:-1] + (steps,), dtype=jnp.int32)
        for tap in range(K):  # tap j multiplies u_{t-j}; poly bit (K-1-j)...
            if (poly >> (K - 1 - tap)) & 1:
                acc = acc ^ jax.lax.dynamic_slice_in_dim(
                    padded, tap, steps, axis=-1
                )
        return acc

    # reg bits MSB..LSB = u_{t-6}..u_t ; poly bit i multiplies reg bit i
    # (bit i of reg = u_{t-(i)}... define tap j (0=oldest) <-> poly bit K-1-j)
    c0 = code_bits(G0)
    c1 = code_bits(G1)
    coded = jnp.stack([c0, c1], axis=-1)  # [..., steps, 2]
    mask = _keep_mask(steps, inner_code).reshape(-1)
    flat = coded.reshape(bits.shape[:-1] + (2 * steps,))
    keep_idx = jnp.asarray(np.nonzero(mask)[0])
    return flat[..., keep_idx].astype(jnp.int8)


# ---------------------------------------------------------------------------
# jax Viterbi decode
# ---------------------------------------------------------------------------


SEG_CORE = 128  # decoded bits per parallel Viterbi segment
SEG_OVERLAP = 64  # warmup/cooldown depth (>= ~5K survivor merge depth)
_STRONG = 1e4  # LLR asserting a known zero bit (pre/post-history padding)


def decode(
    llrs: jax.Array,
    nbits: int,
    inner_code: int,
    segmented: bool | None = None,
    backend: str | None = None,
) -> jax.Array:
    """Soft-input Viterbi: llrs [..., num_coded_bits] -> bits [..., nbits] int8.

    LLR convention: positive = bit 0 more likely (matches
    ops.modem.demod_soft_bits). Hard bits b can be passed as ``1 - 2b``.
    Terminated trellis (forced final state 0). ``nbits``/``inner_code`` static.

    ``backend``: "triton" runs both Viterbi loops in one Pallas kernel
    (kernels/viterbi.py; the default on a GPU), "triton_interpret" the same
    kernel in Pallas interpret mode, "xla" the ``lax.scan`` reference (the
    default elsewhere). ``segmented=True`` instead cuts the trellis into
    parallel overlap segments on the scan (approximate at the overlap
    boundaries with astronomically small probability; kept for study).
    """
    if inner_code == 0:
        return (llrs[..., :nbits] < 0).astype(jnp.int8)
    batch_shape = llrs.shape[:-1]
    x = llrs.reshape((-1, llrs.shape[-1])).astype(jnp.float32)
    b = x.shape[0]
    steps = nbits + NTAIL

    # depuncture into [B, steps, 2] with zeros (erasures) at punctured slots
    mask = _keep_mask(steps, inner_code).reshape(-1)
    full = jnp.zeros((b, 2 * steps), dtype=jnp.float32)
    keep_idx = jnp.asarray(np.nonzero(mask)[0])
    full = full.at[:, keep_idx].set(x)
    lam = full.reshape(b, steps, 2)

    backend = choose(backend, "triton", "xla")
    if backend in ("triton", "triton_interpret") and not segmented:
        from liquiddsp_tpu.kernels.viterbi import viterbi_triton

        out0, out1 = _trellis_tables()
        bits = viterbi_triton(
            lam, out0, out1, interpret=backend == "triton_interpret"
        )
        return bits[:, :nbits].reshape(batch_shape + (nbits,))

    if segmented is None:
        segmented = False
    if segmented:
        c, w = SEG_CORE, SEG_OVERLAP
        s = -(-steps // c)
        lw = c + 2 * w
        # pad with strong zero-bit LLRs: the encoder sits at state 0 before
        # t=0 and after termination, so asserted-zero fictional history is
        # exactly the known-boundary condition, uniformly for every segment
        pad_back = (s - 1) * c + lw - w - steps
        lam_p = jnp.pad(
            lam, ((0, 0), (w, pad_back), (0, 0)), constant_values=_STRONG
        )
        wins = jnp.stack(
            [lam_p[:, i * c : i * c + lw] for i in range(s)], axis=1
        )  # [B, S, Lw, 2]
        core = _viterbi_run(
            wins.reshape(b * s, lw, 2), known_start=False, known_end=False
        )  # [B*S, Lw]
        core = core.reshape(b, s, lw)[:, :, w : w + c].reshape(b, s * c)
        bits = core[:, :steps]
    else:
        bits = _viterbi_run(lam, known_start=True, known_end=True)
    return bits[:, :nbits].reshape(batch_shape + (nbits,)).astype(jnp.int8)


def _viterbi_run(lam: jax.Array, known_start: bool, known_end: bool) -> jax.Array:
    """Core ACS + traceback over [B, steps, 2] erasure-padded LLRs -> bits
    [B, steps]. ``known_start/known_end`` pin state 0 at the boundaries
    (terminated full decode); segments use uniform boundaries instead."""
    b, steps, _ = lam.shape

    out0, out1 = _trellis_tables()
    # predecessor tables for new state s': p0 = s'>>1, p1 = (s'>>1)|32, u = s'&1
    sprime = np.arange(NSTATES)
    pred0 = sprime >> 1
    pred1 = (sprime >> 1) | (NSTATES // 2)
    u_of = sprime & 1
    # expected outputs on transition pred -> s' with input u
    e0_p0 = jnp.asarray(1.0 - 2.0 * out0[pred0, u_of])  # [64] signs for c0
    e1_p0 = jnp.asarray(1.0 - 2.0 * out1[pred0, u_of])
    e0_p1 = jnp.asarray(1.0 - 2.0 * out0[pred1, u_of])
    e1_p1 = jnp.asarray(1.0 - 2.0 * out1[pred1, u_of])
    pred0_j = jnp.asarray(pred0)
    pred1_j = jnp.asarray(pred1)

    neg_inf = jnp.float32(-1e9)
    if known_start:
        init_metric = jnp.full((b, NSTATES), neg_inf).at[:, 0].set(0.0)
    else:
        init_metric = jnp.zeros((b, NSTATES), jnp.float32)

    def acs(metrics, lam_t):
        l0 = lam_t[:, 0:1]  # [B,1]
        l1 = lam_t[:, 1:2]
        # metric contribution: LLR positive favors bit 0 -> score = l * sign
        cand0 = metrics[:, pred0_j] + l0 * e0_p0 + l1 * e1_p0
        cand1 = metrics[:, pred1_j] + l0 * e0_p1 + l1 * e1_p1
        take1 = cand1 > cand0
        new_metrics = jnp.where(take1, cand1, cand0)
        # normalize to prevent drift
        new_metrics = new_metrics - jnp.max(new_metrics, axis=1, keepdims=True)
        return new_metrics, take1

    final_metric, decisions = jax.lax.scan(
        acs, init_metric, jnp.moveaxis(lam, 1, 0)
    )
    # decisions [steps, B, 64] bool: True -> predecessor had MSB set

    def traceback(state, dec_t):
        d = jnp.take_along_axis(dec_t, state[:, None], axis=1)[:, 0]
        u = (state & 1).astype(jnp.int8)
        prev = (state >> 1) | jnp.where(d, NSTATES // 2, 0)
        return prev, u

    if known_end:
        final_state = jnp.zeros((b,), dtype=jnp.int32)  # terminated
    else:
        final_state = jnp.argmax(final_metric, axis=1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(traceback, final_state, decisions, reverse=True)
    return jnp.moveaxis(bits_rev, 0, 1)  # [B, steps]


def decode_hard(bits: jax.Array, nbits: int, inner_code: int) -> jax.Array:
    """Hard-decision convenience wrapper: coded bits {0,1} -> message bits."""
    if inner_code == 0:
        return bits[..., :nbits].astype(jnp.int8)
    return decode(1.0 - 2.0 * bits.astype(jnp.float32), nbits, inner_code)
