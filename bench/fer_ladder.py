#!/usr/bin/env python
"""Genie-aided FER loss attribution ladder.

The production RX shows an SNR-dependent implementation loss vs the exact
uncoded AWGN anchors (bench/fer_sweep.py). This bench decomposes that loss per estimation
stage by replacing each stage with its genie (true channel parameters),
cumulatively:

  prod        production pipeline (detect -> fine CFO -> carrier fit ->
              two-stage EQ -> DD phase track -> demod)
  gdet        detector genie: true start/tau/gamma/dphi/phi handed to the
              pipeline (framesync_fixed det_override), fine CFO off
  gcar        + carrier-fit genie (refine=False: the exact dphi/phi from
              the genie detections ARE the carrier model)
  gnoeq       + equalizer off (isolates EQ coefficient noise)
  gnotrack    + DD phase tracking off (isolates tracker noise)

All stages run on the SAME channel realizations (paired trials), so stage
deltas are low-variance. Each stage's FER is also inverted through the
exact theory curve to an effective Es/N0, reported as loss_db — the per
-stage attribution the waterfall-matching contract needs (BASELINE.md:27;
reference estimate-and-correct chain:
/root/reference/lib/frame_detector_cc_impl.cc:89-93).

Usage:
    python bench/fer_ladder.py --cpu --trials 256     # quick CPU run
    python bench/fer_ladder.py --trials 2048          # one GPU
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from bench.fer_sweep import BLOCK, theory_uncoded_fer

# waterfall operating points (theory FER ~ 0.1-0.3): where a fraction of a
# dB moves FER measurably
POINTS = [
    (0, "bpsk", 5.0),
    (1, "qpsk", 7.5),
    (8, "qam16", 15.0),
    (10, "qam64", 20.0),
]

STAGES = ["prod", "gdet", "gcar", "gnoeq", "gnotrack"]


def _stage_kwargs(stage: str) -> dict:
    kw = {}
    if stage in ("gdet", "gcar", "gnoeq", "gnotrack"):
        kw["fine"] = False  # genie dphi is exact; refinement only adds noise
        kw["genie"] = True
    if stage in ("gcar", "gnoeq", "gnotrack"):
        kw["refine"] = False
    if stage in ("gnoeq", "gnotrack"):
        kw["equalize"] = False
    if stage == "gnotrack":
        kw["track"] = False
    return kw


def _loss_db(mod: int, payload_len: int, snr_db: float, fer: float) -> float | None:
    """Invert the exact theory FER curve: the SNR at which theory predicts
    the measured FER; loss = nominal - effective. None when FER is outside
    the invertible range (0 or 1 at this sample size)."""
    if fer <= 0.0 or fer >= 1.0:
        return None
    lo, hi = snr_db - 6.0, snr_db + 6.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if theory_uncoded_fer(mod, payload_len, mid) > fer:
            lo = mid
        else:
            hi = mid
    return snr_db - 0.5 * (lo + hi)


def build_programs(jax, jnp, cfg, trials, payload_len):
    """(channel program, per-stage RX programs) for one config.

    The channel program generates x plus the true per-trial impairment
    parameters (the same randomization as bench/fer_sweep.py's trial
    program); each stage program is one jitted framesync variant consuming
    the SAME x — paired-trial attribution.
    """
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.phy.detector import Detections
    from liquiddsp_tpu.phy.framesync import framesync_fixed

    f = framegen.frame_length(cfg)
    block = BLOCK
    while f + 1024 > block:
        block *= 2

    @jax.jit
    def channel(rng_key, snr_db):
        kp, ko, kph, kg, kc, kt, kn = jax.random.split(rng_key, 7)
        payloads = jax.random.randint(
            kp, (trials, payload_len), 0, 256, dtype=jnp.int32
        ).astype(jnp.uint8)
        frames = framegen.framegen(payloads, cfg)
        x = jnp.pad(frames, ((0, 0), (0, block - f)))
        off = jax.random.randint(ko, (trials,), 200, block - f - 200)
        idx = (jnp.arange(block)[None, :] - off[:, None]) % block
        x = jnp.take_along_axis(x, idx, axis=1)
        phase = jax.random.uniform(kph, (trials, 1), minval=-np.pi, maxval=np.pi)
        gain = jax.random.uniform(kg, (trials, 1), minval=0.5, maxval=1.5)
        cfo = jax.random.uniform(kc, (trials, 1), minval=-0.015, maxval=0.015)
        tt = jnp.arange(block, dtype=jnp.float32)
        x = x * gain * jnp.exp(1j * (cfo * tt + phase))
        frac = jax.random.uniform(kt, (trials, 1), minval=-0.5, maxval=0.5)
        freqs = jnp.fft.fftfreq(block).astype(jnp.float32)
        x = jnp.fft.ifft(
            jnp.fft.fft(x, axis=1) * jnp.exp(-2j * np.pi * freqs * frac), axis=1
        )
        p_sig = jnp.mean(jnp.abs(frames) ** 2) * gain**2
        sigma = jnp.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        noise = sigma * (
            jax.random.normal(kn, (trials, block))
            + 1j * jax.random.normal(jax.random.fold_in(kn, 1), (trials, block))
        )
        x = (x + noise).astype(jnp.complex64)
        return x, payloads, off, phase[:, 0], gain[:, 0], cfo[:, 0], frac[:, 0]

    def make_stage(stage):
        base_kw = _stage_kwargs(stage)
        genie = base_kw.pop("genie", False)

        @jax.jit
        def run(x, payloads, off, phase, gain, cfo, frac):
            kw = dict(base_kw)
            if genie:
                # true channel parameters in the detector's own conventions
                # (phy/detector.py): phi = carrier phase at the frame-start
                # sample (the fractional delay shifts the carrier by
                # -cfo*frac, negligible but exact is free); tau = "signal
                # arrives tau samples late" = +frac; gamma = amplitude gain
                k = 2
                z32 = jnp.zeros((trials, k), jnp.float32)
                col = lambda v: z32.at[:, 0].set(v.astype(jnp.float32))
                phi = jnp.angle(jnp.exp(1j * (phase + cfo * (off - frac))))
                det = Detections(
                    mask=jnp.zeros((trials, k), bool).at[:, 0].set(True),
                    start=jnp.zeros((trials, k), jnp.int32).at[:, 0].set(off),
                    rho=col(jnp.ones_like(phase)),
                    gamma=col(gain),
                    dphi=col(cfo),
                    phi=col(phi),
                    tau=col(frac),
                )
                kw["det_override"] = det
            res = framesync_fixed(x, cfg, max_frames=2, **kw)
            err = jnp.abs(res.start - off[:, None])
            near = (err <= 2) & res.mask
            exact = jnp.all(res.payload == payloads[:, None, :], axis=-1)
            ok = jnp.any(near & res.payload_valid & exact, axis=1)
            return jnp.sum(ok.astype(jnp.int32))

        return run

    return channel, {s: make_stage(s) for s in STAGES}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trials", type=int, default=512)
    ap.add_argument("--payload-len", type=int, default=64)
    ap.add_argument("--out", default="bench/FER_LADDER.json")
    ap.add_argument("--points", default="", help="comma-separated labels subset")
    ap.add_argument("--stages", default="", help="comma-separated stage subset")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    device = init_device(cpu=args.cpu)
    import jax
    import jax.numpy as jnp

    from liquiddsp_tpu.core.config import FrameConfig

    psubset = set(args.points.split(",")) if args.points else None
    ssubset = set(args.stages.split(",")) if args.stages else None
    records = []
    t0 = time.time()
    for mod, label, snr in POINTS:
        if psubset and label not in psubset:
            continue
        cfg = FrameConfig(mod, 0, 0, args.payload_len)
        channel, stages = build_programs(jax, jnp, cfg, args.trials, args.payload_len)
        import zlib

        seed = zlib.crc32(f"{label}:{snr}".encode())  # stable across processes
        chan = channel(jax.random.PRNGKey(seed % (1 << 31)), jnp.float32(snr))
        theory = theory_uncoded_fer(mod, args.payload_len, snr)
        for stage in STAGES:
            if ssubset and stage not in ssubset:
                continue
            ok = int(stages[stage](*chan))
            fer = 1.0 - ok / args.trials
            rec = {
                "config": label,
                "modulation": mod,
                "snr_db": snr,
                "stage": stage,
                "n": args.trials,
                "fer": fer,
                "theory_fer": theory,
                "loss_db": _loss_db(mod, args.payload_len, snr, fer),
            }
            records.append(rec)
            ld = rec["loss_db"]
            print(
                f"{label:6s} snr={snr:5.1f} {stage:9s} fer={fer:.4f} "
                f"(theory {theory:.4f}) loss={'None' if ld is None else f'{ld:+.2f} dB'}",
                file=sys.stderr,
            )
    out = {
        "trials_per_point": args.trials,
        "payload_len": args.payload_len,
        "device": device,
        "elapsed_s": time.time() - t0,
        "stages": STAGES,
        "records": records,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"metric": "fer_ladder_points", "value": len(records), "out": args.out}))


if __name__ == "__main__":
    main()
