"""FEC unit tests: block codes, convolutional/Viterbi, Reed-Solomon, registry.

Mirrors the test taxonomy SURVEY.md section 4 prescribes: bit-exact encode
round-trips, error-correction radii per code family, and host-oracle parity.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu.ops.fec import block, conv, registry, rs


ALL_BLOCK_CODES = [
    block.hamming74(),
    block.hamming128(),
    block.secded2216(),
    block.secded3932(),
    block.secded7264(),
    block.golay2412(),
]


class TestBlockCodes:
    @pytest.mark.parametrize("code", ALL_BLOCK_CODES, ids=lambda c: c.name)
    def test_roundtrip_noiseless(self, code):
        rng = np.random.default_rng(1)
        bits = jnp.asarray(rng.integers(0, 2, size=(3, 5 * code.k)), dtype=jnp.int8)
        coded = code.encode(bits)
        assert coded.shape == (3, 5 * code.n)
        got = code.decode(coded)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))

    @pytest.mark.parametrize("code", ALL_BLOCK_CODES, ids=lambda c: c.name)
    def test_corrects_single_bit_error_per_block(self, code):
        rng = np.random.default_rng(2)
        bits = jnp.asarray(rng.integers(0, 2, size=(1, 4 * code.k)), dtype=jnp.int8)
        coded = np.asarray(code.encode(bits)).copy()
        for blk in range(4):
            pos = blk * code.n + rng.integers(0, code.n)
            coded[0, pos] ^= 1
        got = code.decode(jnp.asarray(coded))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))

    def test_golay_corrects_three_errors(self):
        code = block.golay2412()
        rng = np.random.default_rng(3)
        bits = jnp.asarray(rng.integers(0, 2, size=(1, code.k)), dtype=jnp.int8)
        coded = np.asarray(code.encode(bits)).copy()
        for pos in rng.choice(code.n, size=3, replace=False):
            coded[0, pos] ^= 1
        got = code.decode(jnp.asarray(coded))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))

    def test_golay_distance_8(self):
        # d=8 <=> every weight<=3 error pattern has a unique syndrome:
        # the table holds exactly 24 + 276 + 2024 = 2324 correctable patterns
        code = block.golay2412()
        nonzero = (code._syndrome_table.sum(axis=1) > 0).sum()
        assert nonzero == 2324

    @pytest.mark.parametrize("code", ALL_BLOCK_CODES, ids=lambda c: c.name)
    def test_jax_matches_host(self, code):
        rng = np.random.default_rng(4)
        bits = rng.integers(0, 2, size=(6, code.k), dtype=np.uint8)
        want = code.encode_host(bits)
        got = np.asarray(code.encode(jnp.asarray(bits.reshape(1, -1), dtype=jnp.int8)))
        np.testing.assert_array_equal(got.reshape(6, code.n), want)


class TestConv:
    @pytest.mark.parametrize("inner", [1, 2, 3, 4, 5, 6])
    def test_encode_matches_host(self, inner):
        rng = np.random.default_rng(inner)
        bits = rng.integers(0, 2, size=120, dtype=np.uint8)
        want = conv.encode_host(bits, inner)
        got = np.asarray(conv.encode(jnp.asarray(bits[None], dtype=jnp.int8), inner))[0]
        assert got.shape == want.shape == (conv.num_coded_bits(120, inner),)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("inner", [1, 2, 3, 4, 5, 6])
    def test_viterbi_noiseless_roundtrip(self, inner):
        rng = np.random.default_rng(10 + inner)
        bits = jnp.asarray(rng.integers(0, 2, size=(2, 100)), dtype=jnp.int8)
        coded = conv.encode(bits, inner)
        got = conv.decode_hard(coded, 100, inner)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))

    def test_viterbi_corrects_errors_rate_half(self):
        rng = np.random.default_rng(42)
        bits = jnp.asarray(rng.integers(0, 2, size=(1, 200)), dtype=jnp.int8)
        coded = np.asarray(conv.encode(bits, 1)).copy()
        # flip 8 well-separated bits: rate-1/2 K=7 (dfree=10) corrects these
        for pos in range(10, 400, 50):
            coded[0, pos] ^= 1
        got = conv.decode_hard(jnp.asarray(coded), 200, 1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))

    def test_soft_beats_erasures(self):
        # degraded LLRs still decode when hard decisions would be ambiguous
        rng = np.random.default_rng(43)
        bits = jnp.asarray(rng.integers(0, 2, size=(1, 64)), dtype=jnp.int8)
        coded = np.asarray(conv.encode(bits, 1)).astype(np.float32).copy()
        llr = 1.0 - 2.0 * coded
        llr[0, 5:15] *= 0.01  # near-erasure region
        got = conv.decode(jnp.asarray(llr), 64, 1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(bits))


class TestRS:
    def test_encode_matches_host(self):
        rng = np.random.default_rng(5)
        msg = rng.integers(0, 256, size=64, dtype=np.uint8)
        want = rs.encode_host(msg)
        got = np.asarray(rs.encode(jnp.asarray(msg[None])))[0]
        np.testing.assert_array_equal(got, want)

    def test_roundtrip_noiseless(self):
        rng = np.random.default_rng(6)
        msg = jnp.asarray(rng.integers(0, 256, size=(2, 64), dtype=np.uint8))
        coded = rs.encode(msg)
        assert coded.shape == (2, 64 + 32)
        got = rs.decode(coded, 64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(msg))

    @pytest.mark.parametrize("nerr", [1, 4, 16])
    def test_corrects_byte_errors(self, nerr):
        rng = np.random.default_rng(7 + nerr)
        msg = jnp.asarray(rng.integers(0, 256, size=(1, 64), dtype=np.uint8))
        coded = np.asarray(rs.encode(msg)).copy()
        pos = rng.choice(coded.shape[1], size=nerr, replace=False)
        coded[0, pos] ^= rng.integers(1, 256, size=nerr).astype(np.uint8)
        got = rs.decode(jnp.asarray(coded), 64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(msg))

    def test_multiblock(self):
        rng = np.random.default_rng(9)
        msg = jnp.asarray(rng.integers(0, 256, size=(1, 300), dtype=np.uint8))
        assert rs.block_sizes(300) == [150, 150]
        coded = rs.encode(msg)
        assert coded.shape == (1, 300 + 64)
        got = rs.decode(coded, 300)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(msg))


class TestRegistry:
    @pytest.mark.parametrize("outer", range(8))
    @pytest.mark.parametrize("inner", [0, 1, 6])
    def test_full_pipeline_roundtrip(self, outer, inner):
        rng = np.random.default_rng(outer * 8 + inner)
        L = 67  # 64-byte payload + CRC24
        msg = jnp.asarray(rng.integers(0, 256, size=(2, L), dtype=np.uint8))
        obits = registry.outer_encode(msg, outer)
        assert obits.shape[-1] == registry.outer_encoded_bits(L, outer)
        ibits = registry.inner_encode(obits, inner)
        assert ibits.shape[-1] == registry.inner_encoded_bits(obits.shape[-1], inner)
        # channel: perfect
        llr = 1.0 - 2.0 * ibits.astype(jnp.float32)
        obits_rx = registry.inner_decode(llr, obits.shape[-1], inner)
        got = registry.outer_decode(obits_rx, L, outer)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(msg))


class TestSegmentedViterbi:
    @pytest.mark.parametrize("inner", [1, 2, 4])
    def test_segmented_matches_full(self, inner):
        """Parallel overlap-segmented Viterbi == full sequential decode on
        noisy long messages (survivor merge within the overlap)."""
        rng = np.random.default_rng(21)
        nbits = 1072
        bits = rng.integers(0, 2, (3, nbits)).astype(np.int8)
        coded = np.stack([conv.encode_host(b, inner) for b in bits])
        llr = (1.0 - 2.0 * coded).astype(np.float32)
        llr = llr + 0.45 * rng.standard_normal(llr.shape).astype(np.float32)
        got_seg = np.asarray(
            conv.decode(jnp.asarray(llr), nbits, inner, segmented=True)
        )
        got_full = np.asarray(
            conv.decode(jnp.asarray(llr), nbits, inner, segmented=False)
        )
        np.testing.assert_array_equal(got_seg, got_full)
        np.testing.assert_array_equal(got_full, bits)


def _noisy_llrs(rng, batch, nbits, inner, sigma):
    bits = rng.integers(0, 2, (batch, nbits)).astype(np.int8)
    coded = np.stack([conv.encode_host(b, inner) for b in bits])
    llr = (1.0 - 2.0 * coded).astype(np.float32)
    return llr + sigma * rng.standard_normal(llr.shape).astype(np.float32)


class TestTritonViterbi:
    """kernels/viterbi.py (Pallas interpret mode) bit-exact vs the lax.scan
    reference decoder."""

    @pytest.mark.parametrize("inner", [1, 2, 3, 4, 5, 6])
    def test_interpret_matches_scan(self, inner):
        rng = np.random.default_rng(31 + inner)
        # batch 21: one full tile of 16 plus a padded partial tile
        llr = jnp.asarray(_noisy_llrs(rng, 21, 120, inner, 0.6))
        ref = np.asarray(conv.decode(llr, 120, inner, backend="xla"))
        got = np.asarray(conv.decode(llr, 120, inner, backend="triton_interpret"))
        np.testing.assert_array_equal(ref, got)

    def test_long_trellis(self):
        """The longest trellis of the config space (payload 256 + Golay +
        V27: 4160 steps); the kernel has no length limit of its own."""
        rng = np.random.default_rng(33)
        llr = jnp.asarray(_noisy_llrs(rng, 2, 4154, 1, 0.5))
        ref = np.asarray(conv.decode(llr, 4154, 1, backend="xla"))
        got = np.asarray(conv.decode(llr, 4154, 1, backend="triton_interpret"))
        np.testing.assert_array_equal(ref, got)

    def test_tie_break(self):
        """Coarse LLRs in {-1, 0, +1} make equal path metrics common; a tie
        must keep the predecessor without the high bit, as the scan does."""
        rng = np.random.default_rng(35)
        llr = jnp.asarray(rng.integers(-1, 2, (16, conv.num_coded_bits(200, 1)))
                          .astype(np.float32))
        ref = np.asarray(conv.decode(llr, 200, 1, backend="xla"))
        got = np.asarray(conv.decode(llr, 200, 1, backend="triton_interpret"))
        np.testing.assert_array_equal(ref, got)
        zero = jnp.zeros((3, conv.num_coded_bits(64, 1)), jnp.float32)
        assert not np.asarray(
            conv.decode(zero, 64, 1, backend="triton_interpret")).any()
