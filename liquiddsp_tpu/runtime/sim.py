"""Simulation blocks for flowgraphs: packet source + AWGN channel.

The reference's GRC flowgraphs combine its four blocks with GNU Radio's
own stock sources/channel models; these are the stand-ins so a flowgraph
YAML (grc/graphs/*.yaml) can express a complete closed loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.runtime.bus import PDU, MessageBus


class PacketSource:
    """Random-payload packet source: one PDU per :meth:`step` on ``pdus``.

    Keeps ``sent`` (host copies of every payload) so a driver/test can
    check bit-exact recovery downstream.
    """

    def __init__(self, payload_len: int = 32, seed: int = 0,
                 bus: MessageBus | None = None):
        self.bus = bus or MessageBus()
        self.payload_len = int(payload_len)
        self.rng = np.random.default_rng(seed)
        self.sent: list[np.ndarray] = []

    def step(self) -> PDU:
        p = self.rng.integers(0, 256, (1, self.payload_len), dtype=np.uint8)
        self.sent.append(p[0].copy())
        pdu = PDU(meta={"n": len(self.sent) - 1}, data=p)
        self.bus.publish("pdus", pdu)
        return pdu


@functools.lru_cache(maxsize=None)
def _chan_program(frame_len: int, pad: int, offset: int):
    @jax.jit
    def run(frames, key, snr_db):
        b = frames.shape[0]
        t = frame_len + pad
        x = jnp.zeros((b, t), dtype=jnp.complex64)
        x = x.at[:, offset : offset + frame_len].set(frames)
        p_sig = jnp.mean(jnp.abs(frames) ** 2)
        sigma = jnp.sqrt(p_sig / (2.0 * 10.0 ** (snr_db / 10.0)))
        k1, k2 = jax.random.split(key)
        noise = sigma * (
            jax.random.normal(k1, (b, t)) + 1j * jax.random.normal(k2, (b, t))
        )
        return (x + noise).astype(jnp.complex64)

    return run


class ChannelModel:
    """AWGN channel block: frame PDUs in, padded noisy sample blocks out.

    One compiled program per frame length (config change -> cached
    recompile, same policy as the per-config TX/decode programs in
    runtime/blocks.py). ``set_snr``/the ``snr`` message input retune the
    noise level without recompiles (snr rides as a traced scalar).
    """

    def __init__(self, snr_db: float = 18.0, pad: int = 1024,
                 offset: int = 512, seed: int = 0,
                 bus: MessageBus | None = None):
        self.bus = bus or MessageBus()
        self.snr_db = float(snr_db)
        self.pad = int(pad)
        self.offset = int(offset)
        self._key = jax.random.PRNGKey(int(seed))
        self._n = 0
        self.bus.subscribe("pdus_in", self.apply)
        self.bus.subscribe("snr", self.set_snr)

    def set_snr(self, snr_db) -> None:
        self.snr_db = float(snr_db)

    def apply(self, pdu: PDU | jax.Array) -> jax.Array:
        frames = pdu.data if isinstance(pdu, PDU) else pdu
        f = int(frames.shape[-1])
        self._n += 1
        x = _chan_program(f, self.pad, self.offset)(
            frames, jax.random.fold_in(self._key, self._n),
            jnp.float32(self.snr_db),
        )
        self.bus.publish("samples", x)
        return x
