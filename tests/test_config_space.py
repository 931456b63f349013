"""616-config space sweep (the cognitive engine's full arm space,
/root/reference/python/cognitive_engine.py:525-533).

Three tiers, cheap to expensive:
1. static geometry invariants for all 616 configs x {16, 64, 256}-byte
   payloads (pure host arithmetic — frame_spec vs fec registry lengths);
2. symbol-level noiseless roundtrip (assemble -> decode, no channel) for a
   seeded random sample of configs;
3. full-path framesync loopback for a seeded random subsample.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu.core.config import (
    MOD_BPS,
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
    FrameConfig,
)
from liquiddsp_tpu.ops.fec import registry
from liquiddsp_tpu.phy import frame_spec as fs, framegen
from liquiddsp_tpu.phy.framesync import decode_header, decode_payload_symbols, framesync_fixed

ALL_CONFIGS = [
    (m, i, o)
    for m in range(NUM_MODULATIONS)
    for i in range(NUM_INNER_CODES)
    for o in range(NUM_OUTER_CODES)
]


class TestStaticGeometry:
    @pytest.mark.parametrize("payload_len", [16, 64, 256])
    def test_all_616_configs_geometry(self, payload_len):
        assert len(ALL_CONFIGS) == 616
        for m, i, o in ALL_CONFIGS:
            cfg = FrameConfig(m, i, o, payload_len)
            spec = fs.FrameSpec(cfg)
            msg_bytes = payload_len + fs.CRC_BYTES
            ob = registry.outer_encoded_bits(msg_bytes, o)
            ib = registry.inner_encoded_bits(ob, i)
            assert spec.outer_bits == ob
            assert spec.inner_bits == ib
            # code rates <= 1: coded never shorter than message
            assert ob >= 8 * msg_bytes
            assert ib >= ob
            bps = MOD_BPS[m]
            assert spec.payload_syms == -(-ib // bps)
            assert 0 <= spec.payload_pad_bits < bps
            assert spec.frame_syms == fs.PREAMBLE_SYMS + fs.HEADER_SYMS + spec.payload_syms
            assert spec.frame_samples == fs.K_SAMP * spec.frame_syms + fs.PULSE_TAIL
            assert framegen.frame_length(cfg) == spec.frame_samples

    def test_max_frame_spec_dominates(self):
        """max_frame_spec sizes RX buffers: no config may exceed it."""
        for plen in (16, 64, 256):
            m = fs.max_frame_spec(plen).frame_syms
            worst = max(
                fs.FrameSpec(FrameConfig(mm, i, o, plen)).frame_syms
                for mm, i, o in ALL_CONFIGS
            )
            assert m == worst


def _sampled_configs(n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(ALL_CONFIGS), size=n, replace=False)
    return [ALL_CONFIGS[int(j)] for j in idx]


class TestSampledRoundtrip:
    def test_symbol_level_noiseless_roundtrip_25_configs(self):
        """assemble_symbols -> decode_header + decode_payload_symbols,
        bit-exact, for 25 seeded random configs (no channel, no detector —
        validates the codec/modem/interleave chain across the arm space)."""
        rng = np.random.default_rng(616)
        for m, i, o in _sampled_configs(25, seed=20260818):
            cfg = FrameConfig(m, i, o, payload_len=64)
            payload = jnp.asarray(
                rng.integers(0, 256, (1, 64), dtype=np.uint8)
            )
            syms = framegen.assemble_symbols(payload, cfg)
            h0, h1 = fs.PREAMBLE_SYMS, fs.PREAMBLE_SYMS + fs.HEADER_SYMS
            ok, user, plen, mod, inner, outer = decode_header(syms[..., h0:h1])
            assert bool(ok[0]), f"header failed for {(m, i, o)}"
            assert (int(mod[0]), int(inner[0]), int(outer[0])) == (m, i, o)
            assert int(plen[0]) == 64
            pay, crc_ok = decode_payload_symbols(syms, cfg)
            assert bool(crc_ok[0]), f"payload CRC failed for {(m, i, o)}"
            np.testing.assert_array_equal(
                np.asarray(pay[0]), np.asarray(payload[0]),
                err_msg=f"payload mismatch for {(m, i, o)}",
            )

    def test_exhaustive_616_artifact(self):
        """Tier 4: the committed bench/CONFIG_SPACE.json artifact
        (bench/config_space.py — >= 2 frames of EVERY config through the
        production RX, payloads bit-exact) must record 616/616 ok. Turns
        the sampled tiers above into measured completeness."""
        import json
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench", "CONFIG_SPACE.json",
        )
        if not os.path.exists(path):
            pytest.skip("bench/CONFIG_SPACE.json not generated yet")
        art = json.load(open(path))
        assert art["value"] == 616, art.get("failed_configs")
        assert len(art["results"]) == 616
        assert art["frames_per_config"] >= 2
        assert all(art["results"].values()), [
            k for k, v in art["results"].items() if not v
        ]

    def test_full_path_loopback_sampled(self):
        """Full framesync loopback for 4 seeded random configs at 25 dB."""
        rng = np.random.default_rng(77)
        for m, i, o in _sampled_configs(4, seed=4242):
            cfg = FrameConfig(m, i, o, payload_len=32)
            payload = rng.integers(0, 256, (1, 32), dtype=np.uint8)
            frame = np.asarray(framegen.framegen(jnp.asarray(payload), cfg))
            f = frame.shape[1]
            x = np.zeros((1, f + 1024), dtype=np.complex64)
            x[:, 300 : 300 + f] = frame
            sigma = np.sqrt(np.mean(np.abs(frame) ** 2) / (2 * 10 ** 2.5))
            x = (
                x
                + sigma
                * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)
            res = framesync_fixed(jnp.asarray(x), cfg, max_frames=2)
            pv = np.asarray(res.payload_valid)[0]
            assert pv.any(), f"no decode for {(m, i, o)}"
            k = int(np.nonzero(pv)[0][0])
            np.testing.assert_array_equal(np.asarray(res.payload)[0, k], payload[0])
