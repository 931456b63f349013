"""Cyclic redundancy checks, batched over messages as a JAX op.

The reference pins the payload check to liquid's ``LIQUID_CRC_24``
(lib/flex_tx_impl.cc:52); per-frame ``payload_valid`` is the CRC pass flag
that feeds the cognitive engine's reward (python/cognitive_engine.py:86-89).

Framework spec: CRC-24/OPENPGP — polynomial 0x864CFB, init 0xB704CE,
no reflection, no final xor, 3-byte checksum appended big-endian. CRC-16
(CCITT 0x1021, init 0xFFFF) and CRC-32 (reflected 0xEDB88320) are provided
for completeness of the check family.

Implementation: byte-at-a-time table lookup. The 256-entry table is a
compile-time constant; the per-byte update is a ``lax.scan`` over message
length with the batch dimension vectorized (gather + shifts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

CRC24_POLY = 0x864CFB
CRC24_INIT = 0xB704CE
CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
CRC32_POLY_REFLECTED = 0xEDB88320
CRC32_INIT = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _crc_table(poly: int, width: int) -> np.ndarray:
    """MSB-first CRC table: table[b] = CRC update of byte b from zero state."""
    topbit = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        reg = b << (width - 8)
        for _ in range(8):
            reg = ((reg << 1) ^ poly) if (reg & topbit) else (reg << 1)
            reg &= mask
        table[b] = reg
    return table


def _crc_host(data: bytes, poly: int, width: int, init: int) -> int:
    table = _crc_table(poly, width)
    mask = (1 << width) - 1
    reg = init
    for byte in data:
        idx = ((reg >> (width - 8)) ^ byte) & 0xFF
        reg = ((reg << 8) ^ int(table[idx])) & mask
    return reg


def crc24_host(data: bytes) -> int:
    """Scalar host reference (oracle for the batched op)."""
    return _crc_host(data, CRC24_POLY, 24, CRC24_INIT)


def crc16_host(data: bytes) -> int:
    return _crc_host(data, CRC16_POLY, 16, CRC16_INIT)


def crc32_host(data: bytes) -> int:
    """Standard reflected CRC-32 (IEEE 802.3 / zlib-compatible)."""
    reg = CRC32_INIT
    for byte in data:
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ (CRC32_POLY_REFLECTED if reg & 1 else 0)
    return reg ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _crc_matrix(length: int, poly: int, width: int, init: int):
    """CRC is GF(2)-affine in the message bits: crc(m) = c0 ^ (bits(m) @ F).

    Returns (F [8*length, width] float32 — column j of F is the CRC of the
    unit message with only bit j set and init 0 — and c0 bits [width]
    float32, the CRC of the all-zero message with the real init). One
    [N, 8L] x [8L, W] matmul replaces the per-byte lax.scan — the scan is a
    length-L sequential chain of tiny gathers.
    """
    rows = []
    for j in range(8 * length):
        msg = bytearray(length)
        msg[j // 8] = 0x80 >> (j % 8)  # MSB-first bit order within the byte
        rows.append(_crc_host(bytes(msg), poly, width, 0))
    c0 = _crc_host(bytes(length), poly, width, init)
    f = np.array(
        [[(r >> (width - 1 - b)) & 1 for b in range(width)] for r in rows],
        dtype=np.float32,
    )
    c0_bits = np.array(
        [(c0 >> (width - 1 - b)) & 1 for b in range(width)], dtype=np.float32
    )
    return f, c0_bits


def _crc_jax(msg_bytes: jax.Array, poly: int, width: int, init: int) -> jax.Array:
    """Batched CRC over uint8 messages [..., L] -> uint32 [...].

    GF(2) matmul formulation: unpack bits, one f32 matmul against the
    per-length constant matrix, parity, repack. Exact: row sums < 2^24,
    and 0/1 operands are exact even where the matmul runs in TF32.
    """
    length = msg_bytes.shape[-1]
    f_np, c0_np = _crc_matrix(length, poly, width, init)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (msg_bytes[..., None] >> shifts) & 1  # [..., L, 8] MSB-first
    bits = bits.reshape(msg_bytes.shape[:-1] + (8 * length,)).astype(jnp.float32)
    sums = bits @ jnp.asarray(f_np)  # [..., width]
    par = jnp.mod(sums, 2.0)
    crc_bits = jnp.mod(par + jnp.asarray(c0_np), 2.0).astype(jnp.uint32)
    weights = jnp.asarray(
        [1 << (width - 1 - b) for b in range(width)], dtype=jnp.uint32
    )
    return jnp.sum(crc_bits * weights, axis=-1).astype(jnp.uint32)


@functools.lru_cache(maxsize=None)
def _crc32_matrix(length: int):
    """Reflected CRC-32 is also GF(2)-affine in the message bits; matrix
    columns come from the reflected host reference (bit j of byte i is the
    2^(j) bit — reflected convention, LSB-first within the byte)."""
    rows = []
    for j in range(8 * length):
        msg = bytearray(length)
        msg[j // 8] = 1 << (j % 8)
        rows.append(crc32_host(bytes(msg)) ^ crc32_host(bytes(length)))
    c0 = crc32_host(bytes(length))
    f = np.array(
        [[(r >> b) & 1 for b in range(32)] for r in rows], dtype=np.float32
    )
    c0_bits = np.array([(c0 >> b) & 1 for b in range(32)], dtype=np.float32)
    return f, c0_bits


def crc32(msg_bytes: jax.Array) -> jax.Array:
    """Reflected CRC-32 (zlib-compatible) over uint8 [..., L] -> uint32 [...]."""
    length = msg_bytes.shape[-1]
    f_np, c0_np = _crc32_matrix(length)
    shifts = jnp.arange(8, dtype=jnp.uint8)  # LSB-first (reflected)
    bits = (msg_bytes[..., None] >> shifts) & 1
    bits = bits.reshape(msg_bytes.shape[:-1] + (8 * length,)).astype(jnp.float32)
    par = jnp.mod(bits @ jnp.asarray(f_np) + jnp.asarray(c0_np), 2.0)
    weights = jnp.asarray([1 << b for b in range(32)], dtype=jnp.uint32)
    return jnp.sum(par.astype(jnp.uint32) * weights, axis=-1).astype(jnp.uint32)


def crc24(msg_bytes: jax.Array) -> jax.Array:
    """CRC-24 over uint8 [..., L] -> uint32 [...]."""
    return _crc_jax(msg_bytes, CRC24_POLY, 24, CRC24_INIT)


def crc16(msg_bytes: jax.Array) -> jax.Array:
    return _crc_jax(msg_bytes, CRC16_POLY, 16, CRC16_INIT)


def crc24_append(msg_bytes: jax.Array) -> jax.Array:
    """Append the 3-byte big-endian CRC-24: [..., L] -> [..., L+3]."""
    c = crc24(msg_bytes)
    tail = jnp.stack(
        [(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], axis=-1
    ).astype(jnp.uint8)
    return jnp.concatenate([msg_bytes, tail], axis=-1)


def crc24_check(msg_with_crc: jax.Array) -> jax.Array:
    """Validate trailing CRC-24: [..., L+3] -> bool [...]."""
    body = msg_with_crc[..., :-3]
    tail = msg_with_crc[..., -3:].astype(jnp.uint32)
    expect = (tail[..., 0] << 16) | (tail[..., 1] << 8) | tail[..., 2]
    return crc24(body) == expect
