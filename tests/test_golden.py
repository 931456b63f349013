"""Bit-exactness of JAX ops vs the native C++ golden oracle.

This is the liquid-dsp-replacement contract of SURVEY.md section 7.1: the
batched JAX ops and the independent scalar C++ library implement the same
spec; these tests pin them together bit-for-bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu import golden
from liquiddsp_tpu.core.config import MOD_BPS
from liquiddsp_tpu.ops import crc, modem, msequence, rrc
from liquiddsp_tpu.ops.fec import block, conv, rs


@pytest.fixture(scope="module", autouse=True)
def _build():
    golden.lib()  # builds on first use


class TestGoldenParity:
    def test_msequence(self):
        np.testing.assert_array_equal(
            golden.msequence(7, 0x0089, 1, 254), msequence.msequence_bits(7, 0x0089, 1, 254)
        )

    def test_preamble(self):
        np.testing.assert_allclose(golden.preamble(), msequence.preamble_symbols(), atol=0)

    def test_crc24(self):
        rng = np.random.default_rng(0)
        for n in (1, 3, 22, 67):
            data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            assert golden.crc24(data) == crc.crc24_host(data)
        assert golden.crc24(b"123456789") == 0x21CF02

    def test_crc16(self):
        assert golden.crc16(b"123456789") == 0x29B1

    def test_rrc_taps(self):
        np.testing.assert_allclose(golden.rrc_taps(), rrc.matched_taps(), atol=2e-7)
        np.testing.assert_allclose(
            golden.rrc_taps(dt=0.25), rrc.rrcos_taps(dt=0.25), atol=2e-7
        )

    @pytest.mark.parametrize("mod", range(11))
    def test_constellations(self, mod):
        np.testing.assert_allclose(
            golden.constellation(mod), modem.constellation(mod), atol=2e-7
        )

    @pytest.mark.parametrize("outer", [1, 3, 4, 5, 6, 7])
    def test_block_codes(self, outer):
        code = {
            1: block.golay2412(), 3: block.hamming74(), 4: block.hamming128(),
            5: block.secded2216(), 6: block.secded3932(), 7: block.secded7264(),
        }[outer]
        rng = np.random.default_rng(outer)
        bits = rng.integers(0, 2, 4 * code.k, dtype=np.uint8)
        g_enc = golden.block_encode(outer, bits, code.k)
        j_enc = np.asarray(code.encode(jnp.asarray(bits[None], dtype=jnp.int8)))[0]
        np.testing.assert_array_equal(g_enc, j_enc)
        # corrupt one bit/block, decode parity
        bad = g_enc.copy()
        n = code.n
        for b in range(4):
            bad[b * n + int(rng.integers(0, n))] ^= 1
        g_dec = golden.block_decode(outer, bad, n)
        j_dec = np.asarray(code.decode(jnp.asarray(bad[None], dtype=jnp.int8)))[0]
        np.testing.assert_array_equal(g_dec, j_dec)
        np.testing.assert_array_equal(g_dec, bits)

    @pytest.mark.parametrize("inner", [1, 2, 3, 4, 5, 6])
    def test_conv(self, inner):
        rng = np.random.default_rng(10 + inner)
        bits = rng.integers(0, 2, 96, dtype=np.uint8)
        g_enc = golden.conv_encode(inner, bits)
        j_enc = np.asarray(conv.encode(jnp.asarray(bits[None], dtype=jnp.int8), inner))[0]
        np.testing.assert_array_equal(g_enc, j_enc)
        g_dec = golden.viterbi_decode(inner, g_enc, 96)
        np.testing.assert_array_equal(g_dec, bits)
        j_dec = np.asarray(conv.decode_hard(jnp.asarray(g_enc[None], dtype=jnp.int8), 96, inner))[0]
        np.testing.assert_array_equal(g_dec, j_dec)

    def test_rs(self):
        rng = np.random.default_rng(20)
        msg = rng.integers(0, 256, 64, dtype=np.uint8)
        g_enc = golden.rs_encode_block(msg)
        j_enc = np.asarray(rs.encode_block(jnp.asarray(msg[None])))[0]
        np.testing.assert_array_equal(g_enc, j_enc)
        bad = g_enc.copy()
        pos = rng.choice(len(bad), size=10, replace=False)
        bad[pos] ^= rng.integers(1, 256, size=10).astype(np.uint8)
        g_dec = golden.rs_decode_block(bad, 64)
        j_dec = np.asarray(rs.decode_block(jnp.asarray(bad[None]), 64))[0]
        np.testing.assert_array_equal(g_dec, msg)
        np.testing.assert_array_equal(j_dec, msg)
