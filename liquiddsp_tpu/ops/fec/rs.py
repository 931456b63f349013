"""Reed-Solomon over GF(2^8): RS(255,223), shortened — liquid's RS_M8 analog
(outer code index 2, lib/flex_tx_impl.cc:159-161).

Framework spec:
- field GF(2^8) with primitive polynomial 0x11D, generator element alpha = 2.
- RS(255,223): 32 parity bytes, corrects up to 16 byte errors per block;
  generator polynomial g(x) = prod_{i=1..32} (x - alpha^i) (fcr = 1).
- messages longer than 223 bytes are split into ceil(L/223) blocks as evenly
  as possible; each block of k_i <= 223 data bytes is encoded shortened
  (virtual leading zeros) to k_i + 32 transmitted bytes.

Array mapping: GF multiplies go through log/exp table gathers; the
encoder is a ``lax.scan`` LFSR over message bytes with the 32-wide parity
state vectorized (and batch vectorized); syndromes are Horner scans; the
Berlekamp-Massey iteration is a fixed-32-step ``fori_loop`` with
where-masked updates (no data-dependent control flow); Chien search and
Forney are dense table-gather evaluations over all 255 positions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PRIM_POLY = 0x11D
NN = 255  # block length
KK = 223  # data bytes per full block
NROOTS = 32  # parity bytes
T = 16  # correctable byte errors


@functools.lru_cache(maxsize=None)
def _tables():
    """exp[0..511] (doubled for index wrap) and log[0..255] tables."""
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = 0  # by convention; zero handled via masks
    return exp, log


@functools.lru_cache(maxsize=None)
def _genpoly() -> np.ndarray:
    """Generator polynomial coefficients, ascending degree, length NROOTS+1."""
    exp, log = _tables()

    def gmul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % 255])

    g = np.zeros(NROOTS + 1, dtype=np.int32)
    g[0] = 1
    for i in range(1, NROOTS + 1):
        root = int(exp[i])  # alpha^i, fcr=1
        ng = np.zeros_like(g)
        for d in range(NROOTS + 1):
            ng[d] ^= gmul(int(g[d]), root)
            if d > 0:
                ng[d] ^= int(g[d - 1])
        g = ng
    return g


def block_sizes(msg_len: int) -> list[int]:
    """Split a message of ``msg_len`` bytes into near-equal blocks <= KK."""
    nb = -(-msg_len // KK)
    base, rem = divmod(msg_len, nb)
    return [base + (1 if i < rem else 0) for i in range(nb)]


def encoded_len(msg_len: int) -> int:
    return msg_len + NROOTS * len(block_sizes(msg_len))


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def _encode_block_host(msg: np.ndarray) -> np.ndarray:
    exp, log = _tables()
    g = _genpoly()

    def gmul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % 255])

    # LFSR long-division: parity[j] = coefficient of x^j of the running
    # remainder of msg(x) * x^NROOTS mod g(x)
    parity = np.zeros(NROOTS, dtype=np.int32)
    for byte in msg:
        fb = int(byte) ^ int(parity[-1])
        parity = np.concatenate([[0], parity[:-1]])
        if fb:
            for j in range(NROOTS):
                parity[j] ^= gmul(fb, int(g[j]))
    # transmit descending degree after the message
    return np.concatenate([msg, parity[::-1].astype(np.uint8)])


def encode_host(msg: np.ndarray) -> np.ndarray:
    """Full message -> concatenated shortened blocks (numpy oracle)."""
    out = []
    pos = 0
    for k in block_sizes(len(msg)):
        out.append(_encode_block_host(msg[pos : pos + k].astype(np.uint8)))
        pos += k
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# jax encode
# ---------------------------------------------------------------------------


def _gf_mul(a: jax.Array, b: jax.Array, exp: jax.Array, log: jax.Array) -> jax.Array:
    r = exp[(log[a] + log[b]) % 255]
    return jnp.where((a == 0) | (b == 0), 0, r)


def encode_block(msg: jax.Array) -> jax.Array:
    """msg [..., k] uint8 (k <= KK static) -> [..., k + 32] uint8."""
    exp_t, log_t = _tables()
    exp = jnp.asarray(exp_t)
    log = jnp.asarray(log_t)
    g = jnp.asarray(_genpoly()[:NROOTS])  # [32] ascending coefficients
    batch_shape = msg.shape[:-1]
    k = msg.shape[-1]
    m = msg.reshape((-1, k)).astype(jnp.int32)
    b = m.shape[0]

    def step(parity, byte):
        fb = byte ^ parity[:, -1]
        shifted = jnp.concatenate(
            [jnp.zeros((b, 1), dtype=jnp.int32), parity[:, :-1]], axis=1
        )
        upd = _gf_mul(fb[:, None], g[None, :], exp, log)
        return shifted ^ upd, None

    parity, _ = jax.lax.scan(step, jnp.zeros((b, NROOTS), dtype=jnp.int32), jnp.moveaxis(m, 1, 0))
    out = jnp.concatenate([m, parity[:, ::-1]], axis=1).astype(jnp.uint8)
    return out.reshape(batch_shape + (k + NROOTS,))


# ---------------------------------------------------------------------------
# jax decode
# ---------------------------------------------------------------------------


def decode_block(code: jax.Array, k: int) -> jax.Array:
    """code [..., k+32] uint8 -> corrected data [..., k] uint8.

    Berlekamp-Massey + Chien + Forney, all static control flow. Shortened
    block: positions are indexed as if padded to 255 with leading zeros.
    """
    exp_t, log_t = _tables()
    exp = jnp.asarray(exp_t)
    log = jnp.asarray(log_t)
    n = k + NROOTS
    batch_shape = code.shape[:-1]
    r = code.reshape((-1, n)).astype(jnp.int32)
    b = r.shape[0]

    # --- syndromes S_i = r(alpha^i), i = 1..NROOTS; Horner over bytes ---
    def horner(acc, byte):
        i = jnp.arange(1, NROOTS + 1)
        acc = _gf_mul(acc, exp[i][None, :], exp, log) ^ byte[:, None]
        return acc, None

    syn, _ = jax.lax.scan(horner, jnp.zeros((b, NROOTS), dtype=jnp.int32), jnp.moveaxis(r, 1, 0))
    no_errors = jnp.all(syn == 0, axis=1)  # [B]

    # --- Berlekamp-Massey (fixed NROOTS iterations, masked updates) ---
    # C: error locator (ascending, len T2=NROOTS+1), B: previous locator
    t2 = NROOTS + 1
    c0 = jnp.zeros((b, t2), dtype=jnp.int32).at[:, 0].set(1)
    b0 = c0
    el0 = jnp.zeros((b,), dtype=jnp.int32)  # current L
    bm0 = jnp.ones((b,), dtype=jnp.int32)  # b (last discrepancy)
    mshift0 = jnp.ones((b,), dtype=jnp.int32)  # m: shift count x^m

    def bm_step(i, carry):
        c, bb, el, bmv, m = carry
        # discrepancy d = sum_{j=0..L} C[j] * S[i-j]
        j = jnp.arange(t2)
        sidx = i - j  # syndrome index (0-based into syn)
        valid = (sidx >= 0) & (j <= el[:, None])
        s_j = jnp.where(valid, syn[:, jnp.clip(sidx, 0, NROOTS - 1)], 0)
        terms = _gf_mul(c, s_j, exp, log)
        d = jax.lax.reduce(jnp.where(valid, terms, 0), jnp.int32(0), jax.lax.bitwise_xor, [1])

        d_zero = d == 0
        # coefficient d/b
        coef = _gf_mul(d, exp[(255 - log[jnp.maximum(bmv, 1)]) % 255], exp, log)
        # shifted B by m: B * x^m
        def shift_by(arr, m_):
            idx = jnp.arange(t2)[None, :] - m_[:, None]
            ok = idx >= 0
            return jnp.where(ok, jnp.take_along_axis(arr, jnp.clip(idx, 0, t2 - 1), axis=1), 0)

        xb = shift_by(bb, m)
        c_new = c ^ _gf_mul(coef[:, None], xb, exp, log)
        grow = (~d_zero) & (2 * el <= i)
        c_out = jnp.where(d_zero[:, None], c, c_new)
        b_out = jnp.where(grow[:, None], c, bb)
        el_out = jnp.where(grow, i + 1 - el, el)
        bm_out = jnp.where(grow, d, bmv)
        m_out = jnp.where(d_zero | ~grow, m + 1, jnp.ones_like(m))
        return (c_out, b_out, el_out, bm_out, m_out)

    c, _, el, _, _ = jax.lax.fori_loop(0, NROOTS, bm_step, (c0, b0, el0, bm0, mshift0))

    # --- Chien search over the n transmitted positions ---
    # received position p (0..n-1) corresponds to codeword position
    # j = NN - n + p (leading zeros virtual); error locator root at
    # X^{-1} = alpha^{-j_rev}... Standard: error at position j (power of
    # alpha for evaluation): evaluate Lambda(alpha^{-j'}) where j' is the
    # index from the end. We evaluate at all alpha^{-j'}, j' = 0..n-1 with
    # j' counted from the last byte (degree-0 end).
    jprime = jnp.arange(n)  # 0 = last transmitted byte
    powers = jnp.arange(t2)
    # eval_mat[j', deg] = alpha^{-j' * deg} = exp[(255 - (j'*deg) % 255) % 255]
    expnt = (jprime[:, None] * powers[None, :]) % 255
    eval_mat = exp[(255 - expnt) % 255]  # [n, t2]
    lam_terms = _gf_mul(c[:, None, :], eval_mat[None, :, :], exp, log)  # [B, n, t2]
    lam_val = jax.lax.reduce(lam_terms, jnp.int32(0), jax.lax.bitwise_xor, [2])
    is_err = lam_val == 0  # [B, n]

    # --- Forney: error magnitudes ---
    # Omega(x) = [S(x) * Lambda(x)] mod x^NROOTS ; S(x) = sum S_i x^{i-1}
    conv_idx = jnp.arange(NROOTS)
    # omega[d] = XOR_{j<=d} S[d-j] * C[j]
    jj = jnp.arange(t2)
    dd = conv_idx[:, None]
    sidx = dd - jj[None, :]
    validc = (sidx >= 0) & (sidx < NROOTS)
    s_terms = jnp.where(validc[None], syn[:, jnp.clip(sidx, 0, NROOTS - 1)], 0)
    om_terms = _gf_mul(s_terms, c[:, None, :], exp, log)
    omega = jax.lax.reduce(jnp.where(validc[None], om_terms, 0), jnp.int32(0), jax.lax.bitwise_xor, [2])  # [B, NROOTS]

    # Lambda'(x): formal derivative -> odd-degree terms
    deriv = c[:, 1::2]  # coefficients of x^{even} in Lambda'
    dpow = jnp.arange(deriv.shape[1]) * 2
    om_pow = conv_idx
    xinv = exp[(255 - (jprime[:, None] * om_pow[None, :]) % 255) % 255]  # [n, NROOTS]
    om_val_terms = _gf_mul(omega[:, None, :], xinv[None], exp, log)
    om_val = jax.lax.reduce(om_val_terms, jnp.int32(0), jax.lax.bitwise_xor, [2])  # [B, n]
    xinv_d = exp[(255 - (jprime[:, None] * dpow[None, :]) % 255) % 255]  # [n, ndpow]
    dv_terms = _gf_mul(deriv[:, None, :], xinv_d[None], exp, log)
    dv_val = jax.lax.reduce(dv_terms, jnp.int32(0), jax.lax.bitwise_xor, [2])  # [B, n]

    # magnitude = X^{1-fcr} * Omega(X^{-1}) / Lambda'(X^{-1}); fcr=1 -> no X factor
    inv_dv = exp[(255 - log[jnp.maximum(dv_val, 1)]) % 255]
    mag = _gf_mul(om_val, jnp.where(dv_val == 0, 0, inv_dv), exp, log)
    err = jnp.where(is_err, mag, 0)  # [B, n] — but indexed by j' (from end)
    err = err[:, ::-1]  # back to transmit order
    too_many = el > T
    corrected = jnp.where((no_errors | too_many)[:, None], r, r ^ err)
    return corrected[:, :k].astype(jnp.uint8).reshape(batch_shape + (k,))


def encode(msg: jax.Array) -> jax.Array:
    """Message [..., L] -> shortened-block concatenation [..., encoded_len(L)]."""
    outs = []
    pos = 0
    for k in block_sizes(msg.shape[-1]):
        outs.append(encode_block(msg[..., pos : pos + k]))
        pos += k
    return jnp.concatenate(outs, axis=-1)


def decode(code: jax.Array, msg_len: int) -> jax.Array:
    """Coded [..., encoded_len(L)] -> corrected message [..., L]."""
    outs = []
    pos = 0
    for k in block_sizes(msg_len):
        outs.append(decode_block(code[..., pos : pos + k + NROOTS], k))
        pos += k + NROOTS
    return jnp.concatenate(outs, axis=-1)
