"""Linear modems: the reference's 11 constellations, batched mod/demod.

Modulation index space 0-10 -> {PSK2, PSK4, PSK8, PSK16, DPSK2, DPSK4, DPSK8,
ASK4, QAM16, QAM32, QAM64} exactly as the reference maps integers to liquid
schemes (lib/flex_tx_impl.cc:76-116; inverse map lib/flex_rx_impl.cc:139-179).

Symbol mappings are framework-defined (gray-coded PSK/ASK/QAM, cross QAM32;
liquid's exact tables are not replicated — TX and RX here share one table, so
loopback consistency holds by construction).

All constellations have unit average energy. Hard demodulation is a
minimum-distance search expressed as an inner-product score over the
constellation, an elementwise broadcast (no matmul, so no TF32 rounding).

DPSK is differential: TX accumulates phase increments (parallel cumsum), RX
demodulates the one-lag phase difference r_n * conj(r_{n-1}) against the
increment constellation, with reference phase 0 (previous symbol := 1+0j) at
frame start.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.core.config import MOD_BPS, Modulation

_SQRT2 = np.sqrt(2.0)


def _gray_encode(x: np.ndarray) -> np.ndarray:
    return x ^ (x >> 1)


def _gray_decode_scalar(g: int) -> int:
    x = 0
    while g:
        x ^= g
        g >>= 1
    return x


def _pam_table(nbits: int) -> np.ndarray:
    """Gray-coded PAM levels for one axis: data m -> level, unit peak spacing 2."""
    n = 1 << nbits
    levels = (2.0 * np.arange(n) - (n - 1)).astype(np.float64)  # -n+1 .. n-1 step 2
    table = np.empty(n)
    for pos in range(n):
        table[_gray_encode(np.array(pos)).item()] = levels[pos]
    return table


def _psk_table(nbits: int, offset: float = 0.0) -> np.ndarray:
    m = 1 << nbits
    table = np.empty(m, dtype=np.complex128)
    for pos in range(m):
        data = _gray_encode(np.array(pos)).item()
        table[data] = np.exp(1j * (2.0 * np.pi * pos / m + offset))
    return table


@functools.lru_cache(maxsize=None)
def constellation(mod: int) -> np.ndarray:
    """Constellation table [2**bps] complex64, unit average energy.

    For DPSK schemes this is the *increment* constellation (the phase-step
    alphabet); absolute symbols are produced by differential accumulation.
    """
    mod = int(mod)
    if mod == Modulation.PSK2:
        t = np.array([1.0 + 0j, -1.0 + 0j])
    elif mod == Modulation.PSK4:
        # (+/-1 +/- 1j)/sqrt2; bits (b1 b0) -> (I sign, Q sign): naturally gray
        t = np.array(
            [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex128
        ) / _SQRT2
    elif mod == Modulation.PSK8:
        t = _psk_table(3)
    elif mod == Modulation.PSK16:
        t = _psk_table(4)
    elif mod == Modulation.DPSK2:
        t = _psk_table(1)
    elif mod == Modulation.DPSK4:
        t = _psk_table(2)
    elif mod == Modulation.DPSK8:
        t = _psk_table(3)
    elif mod == Modulation.ASK4:
        t = _pam_table(2) / np.sqrt(5.0)
        t = t.astype(np.complex128)
    elif mod == Modulation.QAM16:
        pam = _pam_table(2)
        t = np.array([pam[m >> 2] + 1j * pam[m & 3] for m in range(16)]) / np.sqrt(10.0)
    elif mod == Modulation.QAM64:
        pam = _pam_table(3)
        t = np.array([pam[m >> 3] + 1j * pam[m & 7] for m in range(64)]) / np.sqrt(42.0)
    elif mod == Modulation.QAM32:
        # cross constellation: 6x6 grid minus the four corners, serpentine
        # index order (framework-defined mapping; liquid's QAM32 is also cross)
        pts = []
        axis = np.array([-5.0, -3.0, -1.0, 1.0, 3.0, 5.0])
        for r, q in enumerate(axis[::-1]):
            row = [complex(i, q) for i in axis if not (abs(i) == 5 and abs(q) == 5)]
            if r % 2:
                row = row[::-1]
            pts.extend(row)
        t = np.array(pts)
        t = t / np.sqrt(np.mean(np.abs(t) ** 2))
    else:
        raise ValueError(f"unknown modulation {mod}")
    assert len(t) == (1 << MOD_BPS[mod])
    # normalize average energy to exactly 1
    t = t / np.sqrt(np.mean(np.abs(t) ** 2))
    return t.astype(np.complex64)


def is_differential(mod: int) -> bool:
    return mod in (Modulation.DPSK2, Modulation.DPSK4, Modulation.DPSK8)


def rotational_symmetry(mod: int) -> float:
    """Smallest rotation (radians) mapping the constellation onto itself.

    A decision-directed phase estimate is only observable modulo this angle
    (a slip by it relabels every symbol consistently); carrier trackers must
    unwrap across observations with steps below half of it.
    """
    mod = int(mod)
    if mod in (Modulation.PSK2, Modulation.DPSK2, Modulation.ASK4):
        return float(np.pi)
    if mod == Modulation.PSK8 or mod == Modulation.DPSK8:
        return float(np.pi / 4)
    if mod == Modulation.PSK16:
        return float(np.pi / 8)
    # PSK4/DPSK4 and the square/cross QAMs are fourfold symmetric
    return float(np.pi / 2)


# ---------------------------------------------------------------------------
# bit <-> symbol-index packing (MSB-first)
# ---------------------------------------------------------------------------


def bits_to_indices(bits: jax.Array, bps: int) -> jax.Array:
    """Pack bits [..., n*bps] (int, MSB-first per symbol) -> indices [..., n]."""
    shape = bits.shape[:-1] + (bits.shape[-1] // bps, bps)
    b = bits.reshape(shape).astype(jnp.int32)
    weights = jnp.asarray([1 << (bps - 1 - i) for i in range(bps)], dtype=jnp.int32)
    return jnp.sum(b * weights, axis=-1)


def indices_to_bits(idx: jax.Array, bps: int) -> jax.Array:
    """Unpack indices [..., n] -> bits [..., n*bps] (int8, MSB-first)."""
    shifts = jnp.asarray([bps - 1 - i for i in range(bps)], dtype=jnp.int32)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(idx.shape[:-1] + (idx.shape[-1] * bps,)).astype(jnp.int8)


# ---------------------------------------------------------------------------
# modulate / demodulate
# ---------------------------------------------------------------------------


def modulate(indices: jax.Array, mod: int) -> jax.Array:
    """Symbol indices [..., n] -> complex64 symbols [..., n].

    ``mod`` is static (selects the compiled constellation constant).
    """
    table = jnp.asarray(constellation(mod))
    if not is_differential(mod):
        return table[indices]
    # differential: phase index cumsum mod M over the last axis
    m = table.shape[0]
    # increment phase position of gray-coded data = position in the PSK table
    pos_of_data = np.empty(m, dtype=np.int32)
    for pos in range(m):
        pos_of_data[_gray_encode(np.array(pos)).item()] = pos
    steps = jnp.asarray(pos_of_data)[indices]
    acc = jnp.cumsum(steps, axis=-1) % m
    phases = 2.0 * jnp.pi * acc.astype(jnp.float32) / m
    return jnp.exp(1j * phases).astype(jnp.complex64)


def demod_hard(symbols: jax.Array, mod: int) -> jax.Array:
    """Received symbols [..., n] -> hard symbol indices [..., n] (int32).

    Min-distance via score = Re(r conj(c)) - |c|^2/2, maximized over the
    constellation — elementwise broadcasts that XLA fuses.
    """
    table = jnp.asarray(constellation(mod))
    if is_differential(mod):
        prev = jnp.concatenate(
            [jnp.ones_like(symbols[..., :1]), symbols[..., :-1]], axis=-1
        )
        z = symbols * jnp.conj(prev)
        # normalize magnitude out; compare phase only
        r = z / jnp.maximum(jnp.abs(z), 1e-12)
    else:
        r = symbols
    scores = (
        jnp.real(r)[..., None] * jnp.real(table)
        + jnp.imag(r)[..., None] * jnp.imag(table)
        - 0.5 * (jnp.abs(table) ** 2)
    )
    return jnp.argmax(scores, axis=-1).astype(jnp.int32)


def demod_soft_bits(symbols: jax.Array, mod: int, noise_var: float | jax.Array = 0.1) -> jax.Array:
    """Approximate per-bit LLRs [..., n*bps] (positive = bit 0 more likely).

    Max-log-MAP over the constellation: LLR_b = (min_{c:b=1}|r-c|^2 -
    min_{c:b=0}|r-c|^2) / noise_var. For DPSK the differential symbol is used.
    """
    table = jnp.asarray(constellation(mod))
    bps = MOD_BPS[mod]
    if is_differential(mod):
        prev = jnp.concatenate(
            [jnp.ones_like(symbols[..., :1]), symbols[..., :-1]], axis=-1
        )
        z = symbols * jnp.conj(prev)
        r = z / jnp.maximum(jnp.abs(z), 1e-12)
    else:
        r = symbols
    d2 = jnp.abs(r[..., None] - table) ** 2  # [..., n, M]
    m_idx = np.arange(table.shape[0])
    llrs = []
    for b in range(bps):
        bit = (m_idx >> (bps - 1 - b)) & 1
        d0 = jnp.min(jnp.where(jnp.asarray(bit == 0), d2, jnp.inf), axis=-1)
        d1 = jnp.min(jnp.where(jnp.asarray(bit == 1), d2, jnp.inf), axis=-1)
        llrs.append((d1 - d0) / noise_var)
    return jnp.stack(llrs, axis=-1).reshape(symbols.shape[:-1] + (symbols.shape[-1] * bps,))
