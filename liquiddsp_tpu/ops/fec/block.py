"""Systematic GF(2) linear block codes: Hamming(7,4), Hamming(12,8),
SEC-DED(22,16)/(39,32)/(72,64), Golay(24,12).

These are the reference's outer-FEC family (liquid enums selected at
lib/flex_tx_impl.cc:150-181): GOLAY2412, HAMMING74, HAMMING128, SECDED2216,
SECDED3932, SECDED7264. Code constructions are framework-defined standard
ones (shortened Hamming / extended Golay); TX and RX share them, so loopback
bit-exactness holds by construction, and error-correction radii match the
code families' guarantees (1 bit for Hamming/SEC-DED, 3 bits for Golay).

Array mapping: encode is a bit-level matmul with the parity matrix P
(``m @ P mod 2`` as an f32 matmul for large batches); decode is a
syndrome matmul + a table gather (syndrome -> error-bit index), fully
vectorized over blocks. Syndrome tables are small compile-time constants
(max 4096 entries for Golay).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _hamming_parity_matrix(k: int, r: int) -> np.ndarray:
    """P (k x r) of the shortened Hamming code: data columns are the first k
    non-power-of-two values in 1..2**r-1."""
    cols = [v for v in range(1, 1 << r) if v & (v - 1)][:k]
    assert len(cols) == k
    return np.array([[(c >> j) & 1 for j in range(r)] for c in cols], dtype=np.uint8)


def _golay_b_matrix() -> np.ndarray:
    """The 12x12 B matrix of the extended binary Golay [24,12,8] code.

    Quadratic-residue construction: the 11x11 block is the circulant of the
    indicator of {0} u QR(11) = {0,1,3,4,5,9}; bordered by a row/column of
    ones with B[11,11] = 0. Verified perfect-code property in tests (all 2^12
    syndromes reached by weight<=3 error patterns).
    """
    qr = {0, 1, 3, 4, 5, 9}
    b = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            b[i, j] = 1 if ((j - i) % 11) in qr else 0
        b[i, 11] = 1
    b[11, :11] = 1
    b[11, 11] = 0
    return b


def _decode_golay_packed(s: jax.Array) -> jax.Array:
    """Arithmetic extended-Golay decoder: packed 12-bit syndrome [...] ->
    packed 12-bit DATA error pattern e_u (parity errors never touch data).

    The standard table-free decoder, valid because G = [I | B] is self-dual
    (B B^T = I mod 2): with e = [e_u | e_v] and s = e_u B xor e_v, exactly
    one of 26 candidates covers every coset of weight <= 3 —
      wt(s) <= 3                 -> e_u = 0
      wt(s ^ B_i) <= 2           -> e_u = delta_i          (B_i = row i of B)
      t = s B^T: wt(t) <= 3      -> e_u = t
      wt(t ^ Bcol_i) <= 2        -> e_u = t ^ Bcol_i       (e_v = delta_i)
    Distinct weight-<=3 patterns have distinct syndromes (d_min = 8), so the
    branch that fires is unique and equals the syndrome table's entry;
    weight-4 cosets fire no branch and return 0, also matching the table.
    All ops are popcounts/XORs on packed int32 lanes — no gather, fully
    XLA-fusable (no table gather in the header decode).
    """
    b = _golay_b_matrix().astype(np.int64)
    row_pk = [int(v) for v in b @ (1 << np.arange(12))]  # rows of B, packed
    col_pk = [int(v) for v in b.T @ (1 << np.arange(12))]  # cols of B, packed
    pc = lambda v: lax.population_count(v.astype(jnp.uint32)).astype(jnp.int32)

    done = pc(s) <= 3
    e_u = jnp.zeros_like(s)
    for i in range(12):
        hit = (~done) & (pc(s ^ row_pk[i]) <= 2)
        e_u = jnp.where(hit, 1 << i, e_u)
        done = done | hit
    # t = s B^T, bit j = parity of s & (row j of B)
    t = jnp.zeros_like(s)
    for j in range(12):
        t = t | ((pc(s & row_pk[j]) & 1) << j)
    hit = (~done) & (pc(t) <= 3)
    e_u = jnp.where(hit, t, e_u)
    done = done | hit
    for i in range(12):
        cand = t ^ col_pk[i]
        hit = (~done) & (pc(cand) <= 2)
        e_u = jnp.where(hit, cand, e_u)
        done = done | hit
    return e_u


class LinearBlockCode:
    """Systematic (n, k) binary code with G = [I_k | P], H = [P^T | I_{n-k}].

    ``max_correct`` bounds the weight of error patterns entered into the
    syndrome table (1 for Hamming/SEC-DED, 3 for Golay).
    """

    def __init__(self, name: str, p: np.ndarray, max_correct: int = 1):
        self.name = name
        self.p = p.astype(np.uint8)
        self.k, r = p.shape
        self.n = self.k + r
        self.r = r
        self.max_correct = max_correct
        self._syndrome_table = self._build_syndrome_table()  # host oracle only

    def _syndrome_of(self, err: np.ndarray) -> int:
        # H = [P^T | I_r]; syndrome = err @ H^T
        s = (err[: self.k] @ self.p) % 2
        s = s ^ err[self.k :]
        return int(np.dot(s, 1 << np.arange(self.r)))

    def _build_syndrome_table(self) -> np.ndarray:
        """table[s] = error bitmask (uint64-safe: n <= 72 -> two uint32 words).

        Returns [2**r, n] uint8 error patterns (dense; r <= 12 so <= 4096 rows).
        """
        import itertools

        table = np.zeros((1 << self.r, self.n), dtype=np.uint8)
        filled = np.zeros(1 << self.r, dtype=bool)
        filled[0] = True
        positions = range(self.n)
        for w in range(1, self.max_correct + 1):
            for combo in itertools.combinations(positions, w):
                err = np.zeros(self.n, dtype=np.uint8)
                err[list(combo)] = 1
                s = self._syndrome_of(err)
                if not filled[s]:
                    table[s] = err
                    filled[s] = True
        return table

    # -- host (oracle) ------------------------------------------------------

    def encode_host(self, bits: np.ndarray) -> np.ndarray:
        """[nblocks, k] -> [nblocks, n] (numpy oracle)."""
        parity = (bits @ self.p) % 2
        return np.concatenate([bits, parity], axis=-1).astype(np.uint8)

    def decode_host(self, bits: np.ndarray) -> np.ndarray:
        data, par = bits[:, : self.k], bits[:, self.k :]
        s = ((data @ self.p) % 2) ^ par
        sidx = s @ (1 << np.arange(self.r))
        err = self._syndrome_table[sidx]
        return (bits ^ err)[:, : self.k].astype(np.uint8)

    # -- jax ---------------------------------------------------------------

    def encode(self, bits: jax.Array) -> jax.Array:
        """bits [..., nblocks*k] int8 -> [..., nblocks*n] int8.

        f32 matmul; exact since row sums < 2^24 and 0/1 operands are exact
        even where the matmul runs in TF32."""
        p = jnp.asarray(self.p, dtype=jnp.float32)
        shape = bits.shape[:-1] + (bits.shape[-1] // self.k, self.k)
        m = bits.reshape(shape).astype(jnp.float32)
        parity = jnp.mod(m @ p, 2.0)
        out = jnp.concatenate([m, parity], axis=-1).astype(jnp.int8)
        return out.reshape(bits.shape[:-1] + (shape[-2] * self.n,))

    def decode(self, bits: jax.Array) -> jax.Array:
        """bits [..., nblocks*n] int8 -> corrected data [..., nblocks*k] int8.

        Gather-free: single-error codes compare the packed syndrome against
        the k data-column syndromes (one broadcast equality, fusable);
        Golay takes the
        arithmetic decoder below. Both are bit-identical to the table
        (single-error syndromes are distinct columns of H; see
        _decode_golay_packed for the Golay argument)."""
        p = jnp.asarray(self.p, dtype=jnp.float32)
        weights = jnp.asarray(1 << np.arange(self.r), dtype=jnp.int32)
        shape = bits.shape[:-1] + (bits.shape[-1] // self.n, self.n)
        c = bits.reshape(shape).astype(jnp.int32)
        data, par = c[..., : self.k], c[..., self.k :]
        syn = jnp.mod(data.astype(jnp.float32) @ p, 2.0).astype(jnp.int32) ^ par
        sidx = jnp.sum(syn * weights, axis=-1)  # [..., nb] packed syndrome
        if self.name == "golay2412":
            e_u = _decode_golay_packed(sidx)
            err = (e_u[..., None] >> jnp.arange(self.k, dtype=jnp.int32)) & 1
        else:
            # syndrome of a single error in data bit j is row j of P; a
            # weight-1 table correction fires iff sidx matches one of them.
            # Parity-bit errors (sidx = 1<<j) match no data row -> data
            # unchanged, same as the table. max_correct == 1 for this family.
            rows = np.asarray(self.p, np.int64) @ (1 << np.arange(self.r))
            err = (sidx[..., None] == jnp.asarray(rows, jnp.int32)).astype(
                jnp.int32
            )
        corrected = (data ^ err).astype(jnp.int8)
        return corrected.reshape(bits.shape[:-1] + (shape[-2] * self.k,))


@functools.lru_cache(maxsize=None)
def hamming74() -> LinearBlockCode:
    return LinearBlockCode("hamming74", _hamming_parity_matrix(4, 3))


@functools.lru_cache(maxsize=None)
def hamming128() -> LinearBlockCode:
    """Hamming(12,8): Hamming(15,11) shortened to 8 data bits."""
    return LinearBlockCode("hamming128", _hamming_parity_matrix(8, 4))


def _secded(k: int, r: int, name: str) -> LinearBlockCode:
    """Shortened Hamming + overall parity: (k + r + 1, k) SEC-DED code."""
    p_ham = _hamming_parity_matrix(k, r)
    # overall parity column: XOR of data bits and hamming parity bits.
    # For data bit i: 1 ^ sum(P[i]) mod 2 contribution... overall parity bit
    # makes total codeword weight even: p_all = sum(data) + sum(ham_parity).
    col = (1 + p_ham.sum(axis=1)) % 2
    p = np.concatenate([p_ham, col[:, None]], axis=1).astype(np.uint8)
    # NOTE: parity bits' own contribution to the overall parity is handled by
    # treating it as an independent column: p_all = m @ col where col already
    # folds in each data bit's hamming-parity contributions.
    return LinearBlockCode(name, p)


@functools.lru_cache(maxsize=None)
def secded2216() -> LinearBlockCode:
    return _secded(16, 5, "secded2216")


@functools.lru_cache(maxsize=None)
def secded3932() -> LinearBlockCode:
    return _secded(32, 6, "secded3932")


@functools.lru_cache(maxsize=None)
def secded7264() -> LinearBlockCode:
    return _secded(64, 7, "secded7264")


@functools.lru_cache(maxsize=None)
def golay2412() -> LinearBlockCode:
    return LinearBlockCode("golay2412", _golay_b_matrix(), max_correct=3)
