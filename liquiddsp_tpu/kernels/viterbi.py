"""Exact Viterbi decoding of the K=7 code as one Pallas kernel (Triton route).

The plain decoder (ops/fec/conv.py ``_viterbi_run``) is a ``lax.scan``:
one sequential loop step per trellis bit for the add-compare-select, and a
second reversed scan for the traceback. This kernel runs both loops inside
one program per tile of ``TILE_B`` codewords:

- the 64 path metrics of each codeword stay in registers as a [TB, 64]
  f32 tile for the whole trellis;
- the predecessors of new state s' are s'>>1 and (s'>>1)+32, a fixed
  butterfly: splitting the metric row into its halves (states 0-31 and
  32-63) and repeating each entry twice gives both candidate rows, with no
  gather and no matmul;
- each step's 64 survivor decisions pack into two int32 words per codeword
  (states 0-31, 32-63), stored [2, steps, B] in a device-memory output so
  no trellis length is too long for the kernel;
- the traceback walks the packed words backwards in the same program.

The arithmetic is the reference's, in the same order and with the same
tie-break (a tie keeps the predecessor without the high bit), so the
decoded bits are identical (tests/test_fec.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

NSTATES = 64
HALF = NSTATES // 2
TILE_B = 16  # codewords per program (a power of two)
NUM_WARPS = 2
NEG = -1e9  # the reference's "impossible state" metric


def branch_signs(out0: np.ndarray, out1: np.ndarray) -> np.ndarray:
    """[4, 64] f32 LLR signs per new state s': the expected (c0, c1) of the
    transition from predecessor s'>>1 (rows 0, 1) and from (s'>>1)+32
    (rows 2, 3), as +1 for bit 0 and -1 for bit 1."""
    sp = np.arange(NSTATES)
    p0 = sp >> 1
    p1 = p0 + HALF
    u = sp & 1
    return np.stack(
        [
            1.0 - 2.0 * out0[p0, u],
            1.0 - 2.0 * out1[p0, u],
            1.0 - 2.0 * out0[p1, u],
            1.0 - 2.0 * out1[p1, u],
        ]
    ).astype(np.float32)


def _repeat2(h: jax.Array) -> jax.Array:
    """[TB, 32] -> [TB, 64] with out[:, s'] = h[:, s' >> 1]."""
    tb = h.shape[0]
    return jnp.broadcast_to(h[:, :, None], (tb, HALF, 2)).reshape(tb, NSTATES)


def _kernel(lam_ref, e_ref, bits_ref, dec_ref, *, steps: int, interpret: bool):
    cols = pl.ds(pl.program_id(0) * TILE_B, TILE_B)
    state_idx = jax.lax.broadcasted_iota(jnp.int32, (1, NSTATES), 1)
    shifts = state_idx % HALF
    e00, e10, e01, e11 = (e_ref[r, :][None, :] for r in range(4))

    def acs(t, m):
        l0 = lam_ref[0, t, cols][:, None]  # [TB, 1]
        l1 = lam_ref[1, t, cols][:, None]
        lo, hi = jnp.split(m, 2, axis=1)
        cand0 = _repeat2(lo) + l0 * e00 + l1 * e10
        cand1 = _repeat2(hi) + l0 * e01 + l1 * e11
        take1 = cand1 > cand0
        new = jnp.where(take1, cand1, cand0)
        new = new - jnp.max(new, axis=1, keepdims=True)
        # distinct bits, so the sum is the OR (bit 31 wraps to the sign)
        w = jnp.left_shift(take1.astype(jnp.int32), shifts)
        w_lo, w_hi = jnp.split(w, 2, axis=1)
        dec_ref[0, t, cols] = jnp.sum(w_lo, axis=1)
        dec_ref[1, t, cols] = jnp.sum(w_hi, axis=1)
        return new

    m0 = jnp.where(state_idx == 0, 0.0, NEG) + jnp.zeros((TILE_B, 1), jnp.float32)
    jax.lax.fori_loop(0, steps, acs, m0)
    if not interpret:  # the interpreter runs one thread and has no barrier
        # the traceback reads words other threads of this program stored
        pltriton.debug_barrier()

    def traceback(i, state):
        t = steps - 1 - i
        w = jnp.where(state >= HALF, dec_ref[1, t, cols], dec_ref[0, t, cols])
        d = jax.lax.shift_right_logical(w, state & (HALF - 1)) & 1
        bits_ref[t, cols] = (state & 1).astype(jnp.int8)
        return (state >> 1) | (d << 5)

    # terminated trellis: the final state is 0
    jax.lax.fori_loop(0, steps, traceback, jnp.zeros((TILE_B,), jnp.int32))


@functools.partial(jax.jit, static_argnames=("interpret",))
def _run(lam_t, e, *, interpret: bool):
    _, steps, b_pad = lam_t.shape
    kernel = functools.partial(_kernel, steps=steps, interpret=interpret)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    bits, _ = pl.pallas_call(
        kernel,
        grid=(b_pad // TILE_B,),
        in_specs=[full(lam_t.shape), full(e.shape)],
        out_specs=[full((steps, b_pad)), full((2, steps, b_pad))],
        out_shape=[
            jax.ShapeDtypeStruct((steps, b_pad), jnp.int8),
            jax.ShapeDtypeStruct((2, steps, b_pad), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="viterbi",
    )(lam_t, e)
    return bits


def viterbi_triton(
    lam: jax.Array,
    out0: np.ndarray,
    out1: np.ndarray,
    interpret: bool = False,
) -> jax.Array:
    """Terminated-trellis Viterbi: depunctured LLR pairs lam [B, steps, 2]
    (positive = bit 0) -> decoded bits [B, steps] int8. ``out0/out1`` are
    the trellis output tables (conv._trellis_tables). The batch is padded
    to a whole number of ``TILE_B`` tiles with zero LLRs."""
    b, steps, _ = lam.shape
    b_pad = -(-b // TILE_B) * TILE_B
    lam_t = jnp.pad(
        jnp.transpose(lam.astype(jnp.float32), (2, 1, 0)),
        ((0, 0), (0, 0), (0, b_pad - b)),
    )  # [2, steps, B_pad]: each step's LLRs are contiguous over the batch
    e = jnp.asarray(branch_signs(out0, out1))
    bits = _run(lam_t, e, interpret=interpret)
    return bits[:, :b].T
