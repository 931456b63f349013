#!/usr/bin/env python
"""Smoke test of the flexframe PHY on one GPU, through its user entry points.

Each phase prints one line; any failed phase stops the run with a non-zero
exit. The last line of a passing run is one JSON object naming the device.

  (a) device: a CUDA GPU is required (no CPU fallback); complex64 crosses
      host <-> device both ways and eager complex arithmetic is exact;
  (b) parity: each GPU kernel against its plain reference at the bench
      widths (correlator vs the FFT path at HIGHEST precision, Viterbi vs
      the lax.scan decoder bit for bit), the GF(2) matmuls (CRC-24, Golay)
      against the numpy oracles, and the compiled step's memory analysis;
  (c) the two bench.py block configs at 64 x 65536, every frame bit-exact;
  (d) streaming: per-chunk, superstep and run_adaptive, each exactly-once;
  (e) the per-channel resampled path;
  (f) 20 packets through FlexTx -> channel -> FlexRx -> CognitiveEngineBlock
      with host complex64 in and out;
  (g) one payload-256 BPSK + V27 + Golay frame per channel (the longest
      trellis);
  (h) the tests marked ``gpu``, in this process.

``--four`` runs only the sharded path on four GPUs (QPSK + V27 + Golay
frames across every shard boundary): sharded_framesync with the ppermute
halo on meshes (time=4, ch=1) and (time=2, ch=2), and one
ShardedStreamingRx.step, each compared with single-card framesync_fixed.

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py --four``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BATCH, BLOCK = 64, 1 << 16


def _phase(name):
    def deco(fn):
        fn.phase = name
        return fn
    return deco


@_phase("a")
def phase_device(jax, jnp):
    host = (np.arange(12, dtype=np.float32) - 5.5).reshape(3, 4)
    host = (host + 1j * host[::-1]).astype(np.complex64)
    dev = jnp.asarray(host)  # host -> device complex64
    eager = dev * jnp.conj(dev) + (1.5 - 2j) * dev  # eager complex arithmetic
    back = np.asarray(eager)  # device -> host complex64
    want = host * np.conj(host) + (1.5 - 2j) * host
    assert back.dtype == np.complex64 and np.array_equal(back, want)
    return "complex64 put/fetch and eager complex arithmetic exact"


def _block(jax, jnp, cfg, snr_db):
    from bench import cells as bench

    synthesize, expected, max_frames = bench.block_stream(jax, jnp, cfg, snr_db)
    x, payloads = synthesize(jax.random.PRNGKey(0))
    return x, payloads, expected, max_frames


@_phase("b")
def phase_parity(jax, jnp):
    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.kernels import correlator as C
    from liquiddsp_tpu.kernels.correlator import BF16_RTOL
    from liquiddsp_tpu.ops import crc
    from liquiddsp_tpu.ops.fec import conv
    from liquiddsp_tpu.ops.fec.block import golay2412
    from liquiddsp_tpu.phy import detector, frame_spec as fs
    from liquiddsp_tpu.phy.framesync import framesync_fixed

    out = []
    # correlator: kernel vs FFT overlap-save reference at HIGHEST precision
    nofec = FrameConfig(1, 0, 0, 64)
    x, _, _, max_frames = _block(jax, jnp, nofec, 20.0)
    tm = detector.templates_time()
    got = jax.jit(lambda a: C.correlate_reduced(a, tm, backend="triton"))(x)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda a: C.correlate_reduced(a, tm, backend="fft"))(x)
        corr, _ = jax.jit(detector.correlate)(x)
    r_got, r_ref = np.asarray(got["rho2"]), np.asarray(ref["rho2"])
    # lags that can pass the detection threshold, over full template
    # windows (the FFT path's last L-1 lags take their energy from a
    # cumsum difference that cancels to ~0, which the detector gates off)
    live = (r_ref > 0.45 ** 2) & (np.asarray(ref["energy"]) > 1e-9)
    live[:, -tm.shape[1] + 1 :] = False
    rel = float(np.max(np.abs(r_got[live] - r_ref[live]) / r_ref[live]))
    assert rel < BF16_RTOL, f"rho2 relative error {rel} >= {BF16_RTOL}"
    mag = np.sort(np.abs(np.asarray(corr)) ** 2, axis=1)  # [B, F, T]
    off_tie = (mag[:, -1] - mag[:, -2]) > 2 * BF16_RTOL * mag[:, -1]
    fb_ok = np.asarray(got["fbin"])[off_tie] == np.asarray(ref["fbin"])[off_tie]
    assert fb_ok.all(), f"fbin disagrees at {int((~fb_ok).sum())} lags off ties"
    d_got = jax.jit(lambda a: detector.detect(a, max_frames, backend="triton"))(x)
    with jax.default_matmul_precision("highest"):
        d_ref = jax.jit(lambda a: detector.detect(a, max_frames, backend="fft"))(x)
    # top-K returns detections by score, and frames of equal power may
    # swap places under bf16 rounding: compare each row's set of starts
    starts = [sorted(np.asarray(d.start)[b][np.asarray(d.mask)[b]].tolist())
              for d in (d_got, d_ref) for b in range(x.shape[0])]
    n_rows = x.shape[0]
    assert starts[:n_rows] == starts[n_rows:], "detection starts differ"
    n_starts = sum(map(len, starts[:n_rows]))
    out.append(
        f"correlator rho2 max rel err {rel:.3e} (tol {BF16_RTOL}) over "
        f"{int(live.sum())} live lags; fbin equal at {int(off_tie.sum())} "
        f"off-tie lags; {n_starts} detection starts identical"
    )

    # Viterbi: kernel vs lax.scan, bit for bit, at the fec-cell batch
    fec = FrameConfig(1, 1, 1, 64)
    n_cw = BATCH * _block(jax, jnp, fec, 10.0)[3]
    key = jax.random.PRNGKey(7)
    for inner, nbits, b in [(i, fs.FrameSpec(FrameConfig(1, i, 1, 64)).outer_bits,
                             n_cw) for i in range(1, 7)] + [(1, 4154, BATCH)]:
        kb, kn = jax.random.split(jax.random.fold_in(key, inner * nbits))
        bits = jax.random.bernoulli(kb, 0.5, (b, nbits)).astype(jnp.int8)
        coded = conv.encode(bits, inner)
        llr = 1.0 - 2.0 * coded.astype(jnp.float32)
        llr = llr + 0.9 * jax.random.normal(kn, llr.shape)
        dec = {bk: np.asarray(jax.jit(
            lambda l, bk=bk: conv.decode(l, nbits, inner, backend=bk))(llr))
            for bk in ("triton", "xla")}
        assert np.array_equal(dec["triton"], dec["xla"]), (inner, nbits)
        out.append(f"viterbi inner={inner} batch={b} steps={nbits + 6}: "
                   f"bit-exact, BER {np.mean(dec['xla'] != np.asarray(bits)):.2e}")

    # GF(2) matmuls at default precision: exact on 0/1 operands
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 256, (512, 256), dtype=np.uint8)
    got_crc = np.asarray(jax.jit(crc.crc24)(jnp.asarray(msgs)))
    want_crc = np.array([crc.crc24_host(bytes(m)) for m in msgs], np.uint32)
    assert np.array_equal(got_crc, want_crc)
    g = golay2412()
    data = rng.integers(0, 2, (4096, 12), dtype=np.uint8)
    cw = g.encode_host(data)
    assert np.array_equal(np.asarray(g.encode(jnp.asarray(data.reshape(1, -1)))
                                     ).reshape(-1, 24), cw)
    err = np.zeros_like(cw)
    for row, n in zip(err, rng.integers(0, 4, len(err))):
        row[rng.choice(24, n, replace=False)] = 1
    rx_bits = cw ^ err
    got_g = np.asarray(g.decode(jnp.asarray(rx_bits.reshape(1, -1).astype(np.int8))))
    assert np.array_equal(got_g.reshape(-1, 12), g.decode_host(rx_bits))
    out.append("CRC-24 (512 x 256 B) and Golay(24,12) (4096 words, <=3 errors) "
               "equal the numpy oracles")

    for name, cfg in (("nofec", nofec), ("fec", fec)):
        xb, _, _, mf = _block(jax, jnp, cfg, 20.0)
        step = jax.jit(lambda a, c=cfg, m=mf: framesync_fixed(a, c, max_frames=m))
        mem = step.lower(xb).compile().memory_analysis()
        out.append(f"framesync_fixed[{name}] memory: temp "
                   f"{mem.temp_size_in_bytes / 2**20:.1f} MiB, args "
                   f"{mem.argument_size_in_bytes / 2**20:.1f} MiB, out "
                   f"{mem.output_size_in_bytes / 2**20:.1f} MiB")
    return "; ".join(out)


@_phase("c")
def phase_blocks(jax, jnp):
    from bench import cells as bench
    from liquiddsp_tpu.core.config import FrameConfig

    out = []
    for name, cfg, snr in (("nofec", FrameConfig(1, 0, 0, 64), 20.0),
                           ("fec", FrameConfig(1, 1, 1, 64), 10.0)):
        r = bench.bench_config(jax, jnp, cfg, snr)
        out.append(f"{name} {r['decoded_frames_per_block']}/"
                   f"{r['expected_frames_per_block']} bit-exact, "
                   f"{r['ms_per_block']:.3f} ms/block")
    return "; ".join(out)


@_phase("d")
def phase_streaming(jax, jnp):
    from bench import cells as bench
    from liquiddsp_tpu.core.config import FrameConfig

    r = bench.bench_streaming(jax, jnp, FrameConfig(1, 0, 0, 64), 20.0)
    return (f"per-chunk, superstep and run_adaptive each decoded "
            f"{r['expected_frames']} frames exactly once over "
            f"{r['n_chunks']} chunks of {r['chunk_len']}")


@_phase("e")
def phase_resampled(jax, jnp):
    from bench import cells as bench
    from liquiddsp_tpu.core.config import FrameConfig

    r = bench.bench_resampled(jax, jnp, FrameConfig(1, 0, 0, 64), 20.0)
    return (f"{r['decoded_frames_per_block']} frames (>= "
            f"{r['expected_frames_per_block']}) bit-exact after resampling")


@_phase("f")
def phase_closed_loop(jax, jnp):
    from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock
    from liquiddsp_tpu.runtime.blocks import FlexRx, FlexTx

    rng = np.random.default_rng(0)
    tx = FlexTx(modulation=1)
    rx = FlexRx(max_payload_len=32)
    ce = CognitiveEngineBlock(ce_type="epsilon_greedy", seed=0)
    n_ok = 0
    for _ in range(20):
        payload = rng.integers(0, 256, (1, 32), dtype=np.uint8)
        frame = np.asarray(tx.send_pkt(payload).data)  # device -> host c64
        assert frame.dtype == np.complex64
        x = np.zeros((1, frame.shape[1] + 1024), np.complex64)
        x[0, 512 : 512 + frame.shape[1]] = frame[0]
        sigma = np.sqrt(np.mean(np.abs(frame) ** 2) / (2 * 10 ** 2.5))
        x += (sigma * (rng.standard_normal(x.shape)
                       + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
        infos = rx.work(x)  # host complex64 -> device
        assert len(infos) == 1, infos
        info = infos[0]
        ok = bool(info["payload_valid"]) and np.array_equal(
            np.asarray(info["payload"]), payload[0])
        assert ok, "closed-loop packet not decoded bit-exactly at 25 dB"
        n_ok += 1
        new_cfg = ce.handler({
            "header_valid": 1, "payload_valid": 1,
            "modulation": info["modulation"], "inner_code": info["inner_code"],
            "outer_code": info["outer_code"],
        })
        if new_cfg:
            tx.configure(new_cfg)
    return f"{n_ok}/20 packets bit-exact through the adaptation loop"


@_phase("g")
def phase_long_trellis(jax, jnp):
    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.phy.framesync import framesync_fixed

    cfg = FrameConfig(0, 1, 1, 256)  # BPSK + V27 + Golay, payload 256
    rng = np.random.default_rng(5)
    payloads = rng.integers(0, 256, (BATCH, 256), dtype=np.uint8)
    frames = np.asarray(jax.jit(lambda p: framegen.framegen(p, cfg))(payloads))
    f = frames.shape[1]
    x = np.zeros((BATCH, f + 2048), np.complex64)
    x[:, 700 : 700 + f] = frames
    res = jax.jit(lambda a: framesync_fixed(a, cfg, max_frames=2))(jnp.asarray(x))
    pv = np.asarray(res.payload_valid)
    assert pv.sum() == BATCH and pv.any(axis=1).all(), int(pv.sum())
    pay = np.asarray(res.payload)
    for b in range(BATCH):
        k = int(np.nonzero(pv[b])[0][0])
        assert np.array_equal(pay[b, k], payloads[b]), b
    return f"{BATCH}/{BATCH} payload-256 frames ({f} samples) bit-exact"


@_phase("h")
def phase_gpu_tests(jax, jnp):
    import glob

    import pytest

    files = [f for f in sorted(glob.glob(os.path.join(ROOT, "tests", "test_*.py")))
             if "pytest.mark.gpu" in open(f).read()]
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"
    return f"gpu-marked tests passed ({', '.join(map(os.path.basename, files))})"


PHASES = [phase_device, phase_parity, phase_blocks, phase_streaming,
          phase_resampled, phase_closed_loop, phase_long_trellis,
          phase_gpu_tests]


def four_cards(jax, jnp, b=8, t_local=16384):
    """The sharded path on four cards vs single-card framesync_fixed, over
    ``b`` channels of ``4 * t_local`` samples."""
    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.parallel.halo import shard_stream, sharded_framesync
    from liquiddsp_tpu.parallel.mesh import make_mesh
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.phy.framesync import framesync_fixed
    from liquiddsp_tpu.runtime.distributed_stream import ShardedStreamingRx

    assert len(jax.devices()) == 4, jax.devices()
    rng = np.random.default_rng(11)
    out = []

    def decoded(res, shift=0):
        pv, st, pay = (np.asarray(a) for a in
                       (res.payload_valid, res.start, res.payload))
        return {(int(i), int(st[i, k]) + shift): bytes(pay[i, k])
                for i, k in zip(*np.nonzero(pv))}

    def stream(cfg, t, cuts, shift=0):
        """Frames across every cut (and one after each) on every channel,
        with starts moved by ``shift``; returns (x, {(ch, start): payload})."""
        f = framegen.frame_length(cfg)
        starts = sorted(s for s in [c - f // 2 + shift for c in cuts[1:]]
                        + [c + f // 2 + 300 + shift for c in cuts] if s >= 0)
        x = np.zeros((b, t), np.complex64)
        want = {}
        for s in starts:
            pay = rng.integers(0, 256, (b, cfg.payload_len), dtype=np.uint8)
            x[:, s : s + f] = np.asarray(framegen.framegen(jnp.asarray(pay), cfg))
            want.update({(i, s): bytes(pay[i]) for i in range(b)})
        return x, want

    # QPSK + V27 + Golay: every RX stage of the nofec config plus the
    # Viterbi kernel and the outer decode
    cfg = FrameConfig(1, 1, 1, 64)
    single_prog = jax.jit(lambda a: framesync_fixed(a, cfg, max_frames=16))

    def single_card(x):
        return decoded(single_prog(jax.device_put(x, jax.devices()[0])))

    t = 4 * t_local
    x, want = stream(cfg, t, [i * t_local for i in range(4)])
    single = single_card(x)
    assert single == want, ("single-card decode differs from the TX",
                            sorted(set(single) ^ set(want))[:6])
    for n_time, n_ch in ((4, 1), (2, 2)):
        mesh = make_mesh(n_time=n_time, n_ch=n_ch)
        res = jax.jit(lambda a, m=mesh: sharded_framesync(
            a, cfg, m, max_frames_per_shard=8))(shard_stream(x, mesh))
        got = decoded(res)
        assert got == single, (n_time, n_ch, sorted(set(got) ^ set(single))[:6])
        out.append(f"sharded_framesync mesh=(time={n_time}, ch={n_ch}): "
                   f"{len(got)} frames bit-exact and equal to single-card, "
                   f"{3 * b} of them across the shard boundaries")

    # one streaming step: the window is [carry (zeros) | chunk], cut into
    # four shards; a frame straddles each shard boundary on every channel
    rx = ShardedStreamingRx(cfg, make_mesh(n_time=4, n_ch=1), b, t,
                            max_frames_per_shard=8)
    tl = rx.window // 4
    x, want = stream(cfg, t, [i * tl for i in range(4)], shift=-rx.overlap)
    res, _ = rx.step(jnp.asarray(x))
    got = decoded(res, shift=res.epoch)
    single = single_card(x)
    assert got == single == want, (len(got), len(single), len(want))
    out.append(f"ShardedStreamingRx.step: {len(got)} frames bit-exact and "
               "equal to single-card")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    device = init_device()
    import jax
    import jax.numpy as jnp

    t_start = time.perf_counter()
    if args.four:
        for line in four_cards(jax, jnp):
            print(f"[four] {line}", flush=True)
    else:
        for fn in PHASES:
            t0 = time.perf_counter()
            msg = fn(jax, jnp)
            print(f"[{fn.phase}] {fn.__name__[6:]}: ok ({time.perf_counter() - t0:.1f} s)"
                  f" — {msg}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["device_kind"],
        "count": device["count"]}}))


if __name__ == "__main__":
    main()
