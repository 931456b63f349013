#!/usr/bin/env python
"""Weak-scaling harness for the time-sharded RX (BASELINE config 5).

Measures the sharded framesync (shard_map + ppermute halo exchange,
parallel/halo.py) at increasing mesh sizes with CONSTANT per-shard work —
weak scaling: ideal efficiency keeps throughput/device flat.

Modes:
  --cpu N     emulate an N-device mesh on CPU
              (XLA_FLAGS=--xla_force_host_platform_device_count must allow N).
              CPU "devices" are host threads, so absolute numbers are not
              hardware-representative; this validates that per-shard work,
              collective count (one ppermute) and ownership masking scale
              as designed, and catches any hidden cross-shard serialization.
  (default)   the GPUs JAX exposes (one card gives the n=1 point; four
              cards give the full curve).

Prints one JSON line per mesh size:
  {"n_time": N, "samples_per_sec": S, "per_device": S/N, "efficiency": e}
where efficiency is per-device throughput relative to n_time=1.

With --out FILE --tag NAME the points are also merged into a JSON artifact
under the given tag, so the CPU-mesh curve and the GPU points can land in
one file.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="emulate an N-device CPU mesh (must be launched with "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    ap.add_argument("--block", type=int, default=1 << 14,
                    help="samples per shard (constant per-shard work)")
    ap.add_argument("--batch", type=int, default=8, help="channels")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="", help="merge points into this JSON artifact")
    ap.add_argument("--tag", default="", help="artifact key for this run (e.g. cpu_mesh, gpu)")
    ap.add_argument("--fixed-total", action="store_true",
                    help="sharding-overhead mode: hold the TOTAL stream size "
                         "constant (block x max mesh size) and compare the "
                         "sharded program against the 1-device program on the "
                         "same work. On an emulated CPU mesh (virtual devices "
                         "= shared host threads) this is the meaningful "
                         "efficiency measurement: weak scaling there is "
                         "capped at cores/N by the host, not by the design.")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    device = init_device(cpu=bool(args.cpu))
    import jax
    import jax.numpy as jnp

    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.parallel.halo import shard_stream, sharded_framesync
    from liquiddsp_tpu.parallel.mesh import make_mesh
    from liquiddsp_tpu.phy import framegen

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    cfg = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
    f = framegen.frame_length(cfg)

    points = []
    base_per_dev = None
    for n_time in sizes:
        mesh = make_mesh(n_time=n_time, n_ch=1, devices=jax.devices()[:n_time])
        if args.fixed_total:
            t_total = args.block * max(sizes)  # constant total work
            shard_block = t_total // n_time
        else:
            t_total = args.block * n_time  # constant per-shard work
            shard_block = args.block
        max_frames = shard_block // (f + 200) + 2

        @jax.jit
        def synth(key):
            kp, kn = jax.random.split(key)
            payloads = jax.random.randint(
                kp, (args.batch, cfg.payload_len), 0, 256, dtype=jnp.int32
            ).astype(jnp.uint8)
            frames = framegen.framegen(payloads, cfg)
            pat = jnp.concatenate(
                [jnp.zeros((args.batch, 37), jnp.complex64), frames,
                 jnp.zeros((args.batch, 200), jnp.complex64)], axis=1)
            reps = -(-t_total // pat.shape[1])
            x = jnp.tile(pat, (1, reps))[:, :t_total]
            noise = 0.02 * (
                jax.random.normal(kn, (args.batch, t_total))
                + 1j * jax.random.normal(jax.random.fold_in(kn, 1), (args.batch, t_total))
            )
            return (x + noise).astype(jnp.complex64)

        x = shard_stream(synth(jax.random.PRNGKey(0)), mesh)

        @jax.jit
        def rx(x):
            res = sharded_framesync(x, cfg, mesh, max_frames_per_shard=max_frames)
            return jnp.sum(res.payload_valid.astype(jnp.int32))

        n_ok = int(rx(x))  # compile + sync
        assert n_ok > 0, "sharded RX decoded nothing"
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = rx(x)
        int(r)
        dt = (time.perf_counter() - t0) / args.iters
        rate = args.batch * t_total / dt
        if args.fixed_total:
            # overhead mode: same total work on the same host — ideal keeps
            # the TOTAL rate flat as shards are added
            per_dev = rate
        else:
            per_dev = rate / n_time
        if base_per_dev is None:
            base_per_dev = per_dev
        rec = {
            "n_time": n_time,
            "samples_per_sec": rate,
            "per_device": rate / n_time,
            "efficiency": per_dev / base_per_dev,
            "decoded_frames": n_ok,
        }
        points.append(rec)
        print(json.dumps(rec))

    if args.out:
        artifact = {}
        if os.path.exists(args.out):
            with open(args.out) as fh:
                artifact = json.load(fh)
        tag = args.tag or ("cpu_mesh" if args.cpu else "gpu")
        artifact[tag] = {
            "device": device,
            "host_cores": os.cpu_count(),
            "mode": "fixed_total_overhead" if args.fixed_total else "weak_scaling",
            "block_per_shard": args.block,
            "batch": args.batch,
            "iters": args.iters,
            "points": points,
        }
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(json.dumps({"artifact": args.out, "tag": tag,
                          "final_efficiency": points[-1]["efficiency"]}))


if __name__ == "__main__":
    main()
