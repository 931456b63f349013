#!/usr/bin/env python
"""Decompose the streaming and sharded-streaming overheads vs the block RX.

At matched shapes the streaming and sharded paths run slower than the
block RX. This bench times the ladder of program variants on the SAME data and slot
count so each gap is attributable:

  block        framesync_fixed on [B, L]
  window       framesync_fixed on [B, L + overlap] (the streaming window
               shape: isolates the +overlap compute cost)
  step         StreamingRx-style step (concat carry + framesync + mask +
               carry-out) as one jit
  superstep    N-chunk lax.scan of the step (one dispatch)
  sharded1     ShardedStreamingRx.step on an n_time=1 x n_ch=1 mesh (the
               shard_map program with no actual communication)

Usage:  python bench/stream_overhead.py            # one GPU
        python bench/stream_overhead.py --cpu --small
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--out", default="bench/STREAM_OVERHEAD.json")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    device = init_device(cpu=args.cpu)
    import jax
    import jax.numpy as jnp

    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.parallel.mesh import make_mesh
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.phy.framesync import framesync_fixed
    from liquiddsp_tpu.runtime.distributed_stream import ShardedStreamingRx
    from liquiddsp_tpu.runtime.stream import StreamingRx

    cfg = FrameConfig(1, 0, 0, 64)
    B = 8 if args.small else 64
    L = 1 << (13 if args.small else 16)
    N = 4 if args.small else 10
    f = framegen.frame_length(cfg)
    period = 37 + f + int(0.8 * f)
    K = L // period + 2

    @jax.jit
    def synth(key):
        kp, kn = jax.random.split(key)
        payloads = jax.random.randint(kp, (B, 64), 0, 256, dtype=jnp.int32).astype(jnp.uint8)
        frames = framegen.framegen(payloads, cfg)
        pattern = jnp.concatenate(
            [jnp.zeros((B, 37), jnp.complex64), frames,
             jnp.zeros((B, int(0.8 * f)), jnp.complex64)], axis=1)
        reps = -(-(N * L) // pattern.shape[1])
        x = jnp.tile(pattern, (1, reps))[:, : N * L]
        p_sig = jnp.mean(jnp.abs(frames) ** 2)
        sigma = jnp.sqrt(p_sig / (2 * 10 ** 2.0))
        noise = sigma * (jax.random.normal(kn, (B, N * L))
                         + 1j * jax.random.normal(jax.random.fold_in(kn, 1), (B, N * L)))
        return (x + noise).astype(jnp.complex64)

    x = synth(jax.random.PRNGKey(0))
    jax.block_until_ready(x)
    xb = x[:, :L]
    overlap = f - 1

    def timeit(fn, sync):
        fn()  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                r = fn()
            sync(r)
            best = min(best, time.perf_counter() - t0)
        return best / args.iters

    count = jax.jit(lambda r: jnp.sum(r.payload_valid.astype(jnp.int32)))

    # block
    blk = jax.jit(lambda a: framesync_fixed(a, cfg, max_frames=K))
    t_block = timeit(lambda: blk(xb), lambda r: int(count(r)))

    # window (block + overlap samples)
    xw = x[:, : L + overlap]
    win = jax.jit(lambda a: framesync_fixed(a, cfg, max_frames=K))
    t_window = timeit(lambda: win(xw), lambda r: int(count(r)))

    # streaming step / superstep
    rx = StreamingRx(cfg, B, L, max_frames_per_chunk=K)
    t_step = timeit(lambda: rx.step(xb), lambda r: int(count(r)))
    stacked = jax.jit(lambda a: a.reshape(B, N, L))(x)
    jax.block_until_ready(stacked)

    def scan_once():
        rx.reset()
        return rx.superstep(stacked)

    t_scan = timeit(scan_once, lambda r: int(count(r))) / N

    # sharded n_time=1 (shard_map program, no real communication)
    mesh = make_mesh(n_time=1, n_ch=1, devices=jax.devices()[:1])
    srx = ShardedStreamingRx(cfg, mesh, B, L, max_frames_per_shard=K)
    t_shard = timeit(
        lambda: srx.step(xb), lambda r: int(count(r[0]))
    )

    out = {
        "batch": B, "block": L, "n_chunks": N, "k_slots": K,
        "device": device,
        "seconds_per_block": {
            "block": t_block, "window": t_window, "step": t_step,
            "superstep": t_scan, "sharded_n1": t_shard,
        },
        "gsamp_per_sec": {
            "block": B * L / t_block / 1e9,
            "window": B * (L + overlap) / t_window / 1e9,
            "step": B * L / t_step / 1e9,
            "superstep": B * L / t_scan / 1e9,
            "sharded_n1": B * L / t_shard / 1e9,
        },
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"metric": "stream_overhead", **out["gsamp_per_sec"]}))


if __name__ == "__main__":
    main()
