"""Pod-scale continuous streaming RX: time-block sharding + super-block carry.

BASELINE config 5: continuous N-host time-block-sharded RX with overlap-save
halo exchange and frame-straddle reassembly. Two nested carry mechanisms:

- *within* a super-block: each time shard completes boundary-straddling
  frames with one ppermute halo from its right neighbor
  (parallel/halo.sharded_framesync);
- *between* super-blocks: the stream's global tail (last frame_samples - 1
  samples) is prepended to the next super-block, exactly like the
  single-chip StreamingRx carry (runtime/stream.py) — so a frame straddling
  the super-block edge is decoded once, in the block where it starts.

Per-step device work is a single jitted shard_map program (local framesync +
one ppermute + psum'd LinkMetrics); the host only shifts the carry.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.parallel.halo import shard_stream, sharded_framesync
from liquiddsp_tpu.parallel.mesh import CH_AXIS, TIME_AXIS
from liquiddsp_tpu.phy import frame_spec as fs
from liquiddsp_tpu.phy.framesync import FrameResults
from liquiddsp_tpu.utils.metrics import LinkMetrics


class ShardedStreamingRx:
    """Streaming wrapper over an n_time x n_ch mesh.

    ``chunk_len`` is the per-super-block length (must be divisible by
    n_time); each step consumes [batch, chunk_len] new samples.
    """

    def __init__(
        self,
        cfg: FrameConfig,
        mesh,
        batch: int,
        chunk_len: int,
        max_frames_per_shard: int = 8,
        threshold: float = 0.45,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.batch = batch
        self.n_time = mesh.shape[TIME_AXIS]
        spec = fs.FrameSpec(cfg)
        self.frame_samples = spec.frame_samples
        self.overlap = self.frame_samples - 1
        # window length = overlap + chunk, padded so each shard gets an equal
        # time block
        total = self.overlap + chunk_len
        self.pad = (-total) % self.n_time
        self.window = total + self.pad
        if self.window // self.n_time <= self.overlap:
            raise ValueError("chunk too small for the mesh: shard < overlap")
        self.chunk_len = chunk_len
        self.max_frames = max_frames_per_shard
        self.threshold = threshold
        self._carry = self._make_carry()
        self._consumed = 0
        self.start_epoch = 0  # host-side 2^30 base of res.start (int32-wrap
        # guard; same contract as runtime/stream.py StreamingRx._base)

        real_len = self.overlap + chunk_len  # window minus the zero pad

        @jax.jit
        def assemble(carry, chunk):
            # window build + next global tail (last overlap received samples)
            window = jnp.concatenate(
                [carry, chunk,
                 jnp.zeros((carry.shape[0], self.pad), dtype=jnp.complex64)],
                axis=-1,
            )
            new_carry = jnp.concatenate([carry, chunk], axis=-1)[:, -self.overlap :]
            return window, new_carry

        self._assemble = assemble

        @jax.jit
        def step(window, base):
            res = sharded_framesync(
                window, cfg, mesh, max_frames_per_shard=max_frames_per_shard,
                threshold=threshold,
            )
            # mask frames not fully contained in the *received* samples (the
            # zero pad is not future data); they re-appear at the head of the
            # next super-block via the carry
            contained = res.start <= real_len - self.frame_samples
            res = dataclasses.replace(
                res,
                mask=res.mask & contained,
                header_valid=res.header_valid & contained,
                payload_valid=res.payload_valid & contained,
                # start as absolute stream sample index
                start=res.start + base,
            )
            metrics = LinkMetrics.from_results(res, window.shape[-1])
            return res, metrics

        self._step = step

    def _make_carry(self) -> jax.Array:
        return jnp.zeros((self.batch, self.overlap), dtype=jnp.complex64)

    def reset(self) -> None:
        """Zero the carry and stream position (new stream, same jits)."""
        self._carry = self._make_carry()
        self._consumed = 0
        self.start_epoch = 0

    def step(self, chunk: jax.Array):
        """[batch, chunk_len] new samples -> (FrameResults, LinkMetrics).

        Returned ``start`` values are stream sample indices relative to
        ``self.start_epoch`` (zero for streams under 2^30 samples; the
        device-side int32 would otherwise wrap on long-lived streams)."""
        assert chunk.shape == (self.batch, self.chunk_len)
        window, new_carry = self._assemble(self._carry, chunk)
        window = shard_stream(window, self.mesh)
        base_abs = self._consumed - self.overlap
        self.start_epoch = (max(base_abs, 0) >> 30) << 30
        base = jnp.int32(base_abs - self.start_epoch)
        res, metrics = self._step(window, base)
        self._carry = new_carry
        self._consumed += self.chunk_len
        # stamp this step's epoch on the result (host-side static field):
        # absolute index = res.epoch + res.start, safe even if the caller
        # batches several steps before reading self.start_epoch
        return dataclasses.replace(res, epoch=self.start_epoch), metrics
