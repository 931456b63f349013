"""Time-block-sharded streaming RX with ppermute halo exchange.

BASELINE config 5: a contiguous sample stream is split into time blocks over
the mesh ``time`` axis. A frame may straddle a block boundary — the
single-chip streaming contract (runtime/stream.py overlap carry, mirroring
liquid's carry-state across 256-sample chunks, SURVEY.md section 5.7)
becomes a neighbor halo exchange:

- every shard sends the first ``frame_samples - 1`` samples of its block to
  its LEFT neighbor (lax.ppermute ring);
- each shard decodes frames *starting* inside its own block, using the halo
  to complete frames that extend into the right neighbor;
- the last shard's right halo is zero (end of stream) — or, in continuous
  operation, the head of the next super-block (runtime carry).

Ownership (start < T_local) guarantees each frame is decoded exactly once,
with no barrier: the only collective is the one ppermute.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.parallel.mesh import CH_AXIS, TIME_AXIS
from liquiddsp_tpu.phy import frame_spec as fs
from liquiddsp_tpu.phy.framesync import FrameResults, framesync_fixed


def sharded_framesync(
    x: jax.Array,
    cfg: FrameConfig,
    mesh,
    max_frames_per_shard: int = 8,
    threshold: float = 0.45,
) -> FrameResults:
    """RX over a [B, T] stream sharded P(ch, time) on ``mesh``.

    Returns FrameResults with [B, n_time * K] slots; ``start`` entries are
    absolute stream indices. Runs as one shard_map program: local dense
    framesync + one ``lax.ppermute`` halo exchange, which XLA hands to the
    collective library of the platform (NCCL over NVLink between GPUs).
    """
    spec = fs.FrameSpec(cfg)
    frame_samples = spec.frame_samples
    overlap = frame_samples - 1
    n_time = mesh.shape[TIME_AXIS]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(CH_AXIS, TIME_AXIS),
        out_specs=FrameResults(
            mask=P(CH_AXIS, TIME_AXIS),
            header_valid=P(CH_AXIS, TIME_AXIS),
            payload_valid=P(CH_AXIS, TIME_AXIS),
            modulation=P(CH_AXIS, TIME_AXIS),
            inner_code=P(CH_AXIS, TIME_AXIS),
            outer_code=P(CH_AXIS, TIME_AXIS),
            payload_len=P(CH_AXIS, TIME_AXIS),
            header_user=P(CH_AXIS, TIME_AXIS, None),
            payload=P(CH_AXIS, TIME_AXIS, None),
            symbols=P(CH_AXIS, TIME_AXIS, None),
            evm=P(CH_AXIS, TIME_AXIS),
            rssi=P(CH_AXIS, TIME_AXIS),
            cfo=P(CH_AXIS, TIME_AXIS),
            start=P(CH_AXIS, TIME_AXIS),
        ),
        check_vma=False,
    )
    def run(x_local):
        t_local = x_local.shape[-1]
        tidx = jax.lax.axis_index(TIME_AXIS)
        # halo: my head -> left neighbor's tail; shard i receives i+1's
        head = x_local[:, :overlap]
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        h = jax.lax.ppermute(head, TIME_AXIS, perm)
        # the last shard wrapped around to shard 0's head — zero it
        h = jnp.where(tidx == n_time - 1, jnp.zeros_like(h), h)
        window = jnp.concatenate([x_local, h], axis=-1)
        res = framesync_fixed(
            window, cfg, max_frames=max_frames_per_shard, threshold=threshold
        )
        own = res.start < t_local  # frames starting in my block are mine
        return dataclasses.replace(
            res,
            mask=res.mask & own,
            header_valid=res.header_valid & own,
            payload_valid=res.payload_valid & own,
            start=res.start + tidx * t_local,
        )

    return run(x)


def shard_stream(x, mesh):
    """Place a replicated/host [B, T] stream with P(ch, time) sharding."""
    return jax.device_put(x, NamedSharding(mesh, P(CH_AXIS, TIME_AXIS)))
