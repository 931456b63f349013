"""Equalizer tests: static multipath (ISI) channels through the full RX.

liquid's flexframesync includes an equalizer stage after symbol sync
(SURVEY.md section 2.2 flexframesync row; driven from the reference at
lib/flex_rx_impl.cc:213). The block-dense analog is the closed-form two-stage
LS equalizer in phy/framesync.py (_eq_train/_eq_apply). These tests pin:

- bit-exact decode through 2-3 tap static multipath channels that break
  the unequalized RX (the EQ is load-bearing, not decorative);
- no regression on clean AWGN-free channels (identity-biased regularizer);
- multipath + noise with FEC still decodes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.phy import framegen
from liquiddsp_tpu.phy.framesync import framesync_fixed

QPSK = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
QAM16_FEC = FrameConfig(modulation=8, inner_code=1, outer_code=1, payload_len=64)

# 3-tap sample-rate channel: direct path + echoes at 1.0 and 2.5 symbols
CHANNEL = np.zeros(6, dtype=np.complex64)
CHANNEL[0] = 1.0
CHANNEL[2] = 0.45 * np.exp(1j * 0.7)
CHANNEL[5] = 0.30 * np.exp(-1j * 1.1)


def through_channel(payload, cfg, h, offset=400, total=4096, snr_db=None, cfo=0.0, seed=0):
    frame = np.asarray(framegen.framegen(jnp.asarray(payload), cfg))
    x = np.zeros((frame.shape[0], total), dtype=np.complex64)
    x[:, offset : offset + frame.shape[1]] = frame
    x = np.stack([np.convolve(row, h)[:total] for row in x])
    t = np.arange(total)
    x = x * np.exp(1j * cfo * t)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        p_sig = np.mean(np.abs(frame) ** 2)
        sigma = np.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        x = x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return jnp.asarray(x.astype(np.complex64))


class TestEqualizer:
    def test_multipath_decodes_bit_exact(self):
        rng = np.random.default_rng(11)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        x = through_channel(payload, QPSK, CHANNEL)
        res = framesync_fixed(x, QPSK, max_frames=2)
        ok = np.asarray(res.payload_valid[0])
        assert ok.any(), "multipath frame not decoded with EQ"
        k = int(np.argmax(ok))
        np.testing.assert_array_equal(np.asarray(res.payload[0, k]), payload[0])

    def test_equalizer_is_load_bearing(self):
        """The same channel must break the unequalized RX — otherwise the
        multipath test above proves nothing about the EQ."""
        rng = np.random.default_rng(11)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        x = through_channel(payload, QPSK, CHANNEL)
        res = framesync_fixed(x, QPSK, max_frames=2, equalize=False)
        assert not np.asarray(res.payload_valid[0]).any()

    def test_multipath_with_cfo(self):
        rng = np.random.default_rng(12)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        x = through_channel(payload, QPSK, CHANNEL, cfo=0.008)
        res = framesync_fixed(x, QPSK, max_frames=2)
        ok = np.asarray(res.payload_valid[0])
        assert ok.any()
        k = int(np.argmax(ok))
        np.testing.assert_array_equal(np.asarray(res.payload[0, k]), payload[0])

    def test_multipath_noise_fec(self):
        rng = np.random.default_rng(13)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        x = through_channel(payload, QAM16_FEC, CHANNEL, snr_db=22.0, seed=3)
        res = framesync_fixed(x, QAM16_FEC, max_frames=2)
        ok = np.asarray(res.payload_valid[0])
        assert ok.any()
        k = int(np.argmax(ok))
        np.testing.assert_array_equal(np.asarray(res.payload[0, k]), payload[0])

    def test_clean_channel_no_regression(self):
        """Identity-bias regularizer: on an ISI-free channel the EQ must not
        degrade EVM below the decode margin (QAM64 uncoded, noiseless)."""
        cfg = FrameConfig(modulation=10, inner_code=0, outer_code=0, payload_len=64)
        rng = np.random.default_rng(14)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        x = through_channel(payload, cfg, np.ones(1, dtype=np.complex64))
        res = framesync_fixed(x, cfg, max_frames=2)
        ok = np.asarray(res.payload_valid[0])
        assert ok.any()
        k = int(np.argmax(ok))
        np.testing.assert_array_equal(np.asarray(res.payload[0, k]), payload[0])
        assert float(res.evm[0, k]) < -25.0, f"EQ noise floor too high: {float(res.evm[0, k])} dB"
