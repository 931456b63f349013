#!/usr/bin/env python
"""Each hand-written GPU kernel against its plain XLA path, end to end.

Times the full ``framesync_fixed`` step (ms per 64 x 65536 block, the
bench.py shapes) with every implementation of a stage in turn, everything
else unchanged, in one process on one card:

- detect stage on the nofec config: the Triton correlator kernel, the
  block-Toeplitz matmuls in XLA with the kernel's bf16 operands, and the
  FFT overlap-save path;
- payload decode on the fec config: the Triton Viterbi kernel and the
  ``lax.scan`` decoder;
- the symbol-recovery stage (window gather + derotate + matched filter) on
  its own, with the bytes it must move, for a roofline bound.

Variants run in turns (A B C ... C B A) and each reading is the best of
three passes of bench.cells.ITERS blocks. Prints one JSON line, and writes
it to ``--out`` when given.

Run: ``python bench/kernel_ab.py [--out kernel_ab.json]`` (one GPU).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet (SXM)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    from liquiddsp_tpu.utils.init import init_device

    device = init_device()
    import jax
    import jax.numpy as jnp

    from bench import cells as bench
    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.kernels import correlator
    from liquiddsp_tpu.ops.fec import conv
    from liquiddsp_tpu.phy import detector, frame_spec as fs
    from liquiddsp_tpu.phy import framesync

    plain = lambda backend, kernel, plain_path: plain_path
    tm = detector.templates_time()

    def corr_with(fn):
        return mock.patch.object(
            correlator, "correlate_reduced", lambda x, t, backend=None: fn(x, t)
        )

    variants = {
        "nofec": {
            "detect=triton": mock.patch.object(
                correlator, "choose", lambda b, k, p: "triton"),
            "detect=mm_bf16": corr_with(functools.partial(
                correlator.correlate_reduced_mm, dtype=jnp.bfloat16)),
            "detect=fft": corr_with(correlator.correlate_reduced_xla),
        },
        "fec": {
            "viterbi=triton": mock.patch.object(
                conv, "choose", lambda b, k, p: "triton"),
            "viterbi=scan": mock.patch.object(conv, "choose", plain),
        },
    }
    cfgs = {"nofec": (FrameConfig(1, 0, 0, 64), 20.0),
            "fec": (FrameConfig(1, 1, 1, 64), 10.0)}
    result = {"device": device, "ms_per_block": {}, "runs": []}
    for cell, vs in variants.items():
        cfg, snr = cfgs[cell]
        synthesize, expected, max_frames = bench.block_stream(jax, jnp, cfg, snr)
        x, _ = synthesize(jax.random.PRNGKey(0))
        progs = {}
        for name, patch in vs.items():
            with patch:  # trace + compile under the variant
                fn = jax.jit(lambda a: jnp.sum(framesync_fixed_valid(
                    framesync, a, cfg, max_frames)))
                n_ok = int(fn(x))
            assert n_ok == expected, (cell, name, n_ok, expected)
            progs[name] = fn
        order = list(progs) + list(reversed(progs))
        times = {name: [] for name in progs}
        for name in order:
            times[name].append(bench.time_blocks(jax, progs[name], x) * 1e3)
        result["runs"].append({"cell": cell, "order": order, "ms": times})
        for name, ts in times.items():
            result["ms_per_block"][f"{cell}:{name}"] = min(ts)

    # recover stage alone: gather the candidate windows, derotate, filter
    cfg, snr = cfgs["nofec"]
    synthesize, _, max_frames = bench.block_stream(jax, jnp, cfg, snr)
    x, _ = synthesize(jax.random.PRNGKey(0))
    n_syms = fs.FrameSpec(cfg).frame_syms
    det = jax.jit(lambda a: detector.detect(a, max_frames, fine=False))(x)
    stage = jax.jit(lambda a, d: framesync.extract_symbols(a, d, n_syms))
    t = bench.time_blocks(jax, lambda a: stage(a, det), x)
    n_win = fs.K_SAMP * n_syms + fs.PULSE_TAIL
    b, k = det.start.shape
    moved = b * k * (n_win + n_syms) * 8  # complex64 windows in, symbols out
    peak = HBM_BYTES_PER_S.get(device["device_kind"])
    result["recover_stage"] = {
        "ms": t * 1e3, "bytes": moved, "candidates": b * k,
        "roofline_ms": None if peak is None else moved / peak * 1e3,
        "roofline_share": None if peak is None else moved / peak / t,
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


def framesync_fixed_valid(framesync, x, cfg, max_frames):
    res = framesync.framesync_fixed(x, cfg, max_frames=max_frames)
    return res.payload_valid.astype("int32")


if __name__ == "__main__":
    main()
