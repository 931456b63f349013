#!/usr/bin/env python
"""Exhaustive 616-config end-to-end loopback artifact.

Decodes >= 2 frames of EVERY one of the 616 (modulation x inner x outer)
configs — the cognitive engine's full arm space
(/root/reference/python/cognitive_engine.py:525-533) — end-to-end through
the production RX chain, payloads asserted bit-exact. Turns the sampled
completeness of tests/test_config_space.py into measured completeness.

Path: frames from 8 configs at a time are placed in one mixed-config
[8, T] block and decoded by FlexRx (runtime/blocks.py), whose front end is
``sync_common`` and whose per-config back end is ``decode_payload_symbols``
— exactly the two halves ``framesync_fixed`` composes (phy/framesync.py:834)
— so every config's detector/header/payload chain is exercised while the
config-independent sync program compiles ONCE for all 616 (the batched
way to sweep a config space: self-describing frames, shared front end,
616 small per-config codec programs instead of 616 full-pipeline compiles).

SNR per modulation is 18 + 2*bits_per_symbol dB — a completeness proof
wants >99.9% decode margin for the densest uncoded constellations, not a
sensitivity measurement (bench/fer_sweep.py owns the waterfalls).

Writes bench/CONFIG_SPACE.json: {"n_ok": 616, "results": {"m_i_o": ok}}.
tests/test_config_space.py asserts 616/616 on the committed artifact.

Usage:
    python bench/config_space.py --cpu                    # CPU (~10 min)
    python bench/config_space.py --out bench/CONFIG_SPACE.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np

LEAD = 256


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--payload-len", type=int, default=32)
    ap.add_argument("--frames-per-config", type=int, default=2)
    ap.add_argument("--group", type=int, default=8, help="configs per block")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--mods", default="",
                    help="comma-separated modulation indices subset (e.g. "
                         "'0' = the BPSK column: the longest frames per "
                         "payload, the longest trellises)")
    # 616 distinct configs = ~1200 per-config compiled programs; one process
    # holding all of them exhausted 128 GB of host RAM at ~400 configs
    # (LLVM "Cannot allocate memory" -> SIGSEGV). Shards run as SEQUENTIAL
    # subprocesses so each releases its compile cache at exit; the parent
    # merges the partial results.
    ap.add_argument("--shards", type=int, default=8,
                    help="run the sweep as N sequential subprocesses")
    ap.add_argument("--shard-index", type=int, default=-1,
                    help="(internal) this invocation covers shard i of N")
    args = ap.parse_args()

    if args.shards > 1 and args.shard_index < 0:
        import subprocess
        import tempfile

        merged: dict[str, bool] = {}
        elapsed = 0.0
        device = None
        with tempfile.TemporaryDirectory() as td:
            for i in range(args.shards):
                part = os.path.join(td, f"part{i}.json")
                argv = [sys.executable, os.path.abspath(__file__),
                        "--shard-index", str(i), "--shards", str(args.shards),
                        "--payload-len", str(args.payload_len),
                        "--frames-per-config", str(args.frames_per_config),
                        "--group", str(args.group), "--seed", str(args.seed),
                        "--out", part]
                if args.mods:
                    argv += ["--mods", args.mods]
                if args.cpu:
                    argv.append("--cpu")
                rc = subprocess.call(argv)
                if rc not in (0, 1):  # 1 = ran but some config failed
                    print(f"shard {i} failed (rc={rc})", file=sys.stderr)
                    sys.exit(2)
                d = json.load(open(part))
                merged.update(d["results"])
                elapsed += d["elapsed_s"]
                device = d["device"]
        n_ok = sum(merged.values())
        bad = sorted(k for k, v in merged.items() if not v)
        n_mods = len(args.mods.split(",")) if args.mods else 11
        expected = n_mods * 56  # inner x outer = 7 x 8 per modulation
        out = {
            "metric": "config_space_loopback_ok",
            "value": n_ok,
            "unit": f"configs (of {expected})",
            "frames_per_config": args.frames_per_config,
            "payload_len": args.payload_len,
            "mods": args.mods or "all",
            "snr_rule_db": "18 + 2*bits_per_symbol",
            "elapsed_s": elapsed,
            "shards": args.shards,
            "device": device,
            "failed_configs": bad,
            "results": merged,
        }
        assert len(merged) == expected, (len(merged), expected)
        print(json.dumps({k: out[k] for k in
                          ("metric", "value", "unit", "elapsed_s",
                           "failed_configs")}))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        sys.exit(0 if n_ok == expected else 1)

    from liquiddsp_tpu.utils.init import init_device

    device = init_device(cpu=args.cpu)
    import jax.numpy as jnp

    from liquiddsp_tpu.core.config import (
        MOD_BPS,
        NUM_INNER_CODES,
        NUM_MODULATIONS,
        NUM_OUTER_CODES,
        FrameConfig,
    )
    from liquiddsp_tpu.phy import frame_spec as fs, framegen
    from liquiddsp_tpu.runtime.blocks import FlexRx

    plen = args.payload_len
    nf = args.frames_per_config
    configs = [
        (m, i, o)
        for m in range(NUM_MODULATIONS)
        for i in range(NUM_INNER_CODES)
        for o in range(NUM_OUTER_CODES)
    ]
    assert len(configs) == 616
    if args.mods:
        keep = {int(m) for m in args.mods.split(",")}
        configs = [c for c in configs if c[0] in keep]
    if args.shard_index >= 0:
        per = -(-len(configs) // args.shards)
        configs = configs[args.shard_index * per : (args.shard_index + 1) * per]
    maxf = fs.max_frame_spec(plen).frame_samples
    t_block = nf * (maxf + LEAD) + LEAD  # fixed T: ONE sync compile for all

    rng = np.random.default_rng(args.seed)
    rx = FlexRx(max_payload_len=plen, max_frames_per_block=nf + 2)
    results: dict[str, bool] = {}
    t0 = time.perf_counter()
    n_blocks = 0
    for g0 in range(0, len(configs), args.group):
        batch_cfgs = configs[g0 : g0 + args.group]
        b = len(batch_cfgs)
        x = np.zeros((b, t_block), dtype=np.complex64)
        sent = []  # per channel: (cfg, [payloads]) in start order
        for ch, (m, i, o) in enumerate(batch_cfgs):
            cfg = FrameConfig(m, i, o, plen)
            payloads = rng.integers(0, 256, (nf, plen), dtype=np.uint8)
            frames = np.asarray(framegen.framegen(jnp.asarray(payloads), cfg))
            f = frames.shape[1]
            for j in range(nf):
                s = LEAD + j * (maxf + LEAD)
                x[ch, s : s + f] = frames[j]
            # >99.9% decode margin for the densest uncoded constellation
            snr_db = 18.0 + 2.0 * MOD_BPS[m]
            sigma = np.sqrt(
                np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10))
            )
            x[ch] += sigma * (
                rng.standard_normal(t_block) + 1j * rng.standard_normal(t_block)
            ).astype(np.complex64)
            sent.append(((m, i, o), payloads))
        infos = rx.work(x)
        by_ch: dict[int, list] = {}
        for info in infos:
            by_ch.setdefault(info["batch"], []).append(info)
        for ch, ((m, i, o), payloads) in enumerate(sent):
            got = sorted(by_ch.get(ch, []), key=lambda d: d["start"])
            ok = len(got) == nf
            for j, info in enumerate(got[:nf]):
                ok = ok and (
                    (info["modulation"], info["inner_code"], info["outer_code"])
                    == (m, i, o)
                    and bool(info["payload_valid"])
                    and np.array_equal(np.asarray(info["payload"]), payloads[j])
                )
            results[f"{m}_{i}_{o}"] = bool(ok)
        n_blocks += 1
        done = g0 + b
        if n_blocks % 10 == 0 or done == len(configs):
            n_ok = sum(results.values())
            print(
                f"{done}/{len(configs)} configs, {n_ok} ok, "
                f"{time.perf_counter() - t0:.0f}s",
                file=sys.stderr,
            )

    n_ok = sum(results.values())
    bad = sorted(k for k, v in results.items() if not v)
    out = {
        "metric": "config_space_loopback_ok",
        "value": n_ok,
        "unit": f"configs (of {len(configs)})",
        "frames_per_config": nf,
        "payload_len": plen,
        "mods": args.mods or "all",
        "snr_rule_db": "18 + 2*bits_per_symbol",
        "elapsed_s": time.perf_counter() - t0,
        "device": device,
        "failed_configs": bad,
        "results": results,
    }
    print(json.dumps({k: out[k] for k in
                      ("metric", "value", "unit", "elapsed_s", "failed_configs")}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    if n_ok != len(configs):
        sys.exit(1)


if __name__ == "__main__":
    main()
