#!/usr/bin/env python
"""Closed-loop adaptation demo: TX -> channel -> RX -> cognitive engine -> TX.

BASELINE config 4: per-frame modulation/FEC switching under a time-varying
SNR. The channel follows the reference's hard-coded dynamic-noise schedule
(python/cognitive_engine.py:151-167) or a fixed SNR.

    python apps/adaptation_demo.py --ce gittins --packets 200 --snr 18
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ce", default="epsilon_greedy",
                    choices=["epsilon_greedy", "annealing_epsilon_greedy",
                             "gittins", "RoTA", "meta"])
    ap.add_argument("--packets", type=int, default=100)
    ap.add_argument("--snr", type=float, default=18.0)
    ap.add_argument("--dynamic", action="store_true",
                    help="use the reference's dynamic-noise schedule")
    ap.add_argument("--payload-len", type=int, default=32)
    ap.add_argument("--kindicator", default="off", choices=["off", "on"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: require a GPU)")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    init_device(cpu=args.cpu)

    from liquiddsp_tpu.core.config import FrameConfig
    from liquiddsp_tpu.engine.cognitive_engine import CognitiveEngineBlock
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.runtime.blocks import FlexRx

    ce = CognitiveEngineBlock(
        ce_type=args.ce, kindicator=args.kindicator,
        channel="nonstationary" if args.dynamic else "stationary",
        seed=args.seed,
    )
    rx = FlexRx(max_payload_len=args.payload_len)
    rng = np.random.default_rng(args.seed)

    cfg_dict = {"modulation": 1, "inner_code": 0, "outer_code": 0}
    goodputs = []
    for pkt in range(args.packets):
        cfg = FrameConfig(cfg_dict["modulation"], cfg_dict["inner_code"],
                          cfg_dict["outer_code"], args.payload_len)
        payload = rng.integers(0, 256, (1, args.payload_len), dtype=np.uint8)
        frame = np.asarray(framegen.framegen(jnp.asarray(payload), cfg))
        t = frame.shape[1] + 1024
        x = np.zeros((1, t), dtype=np.complex64)
        x[0, 512 : 512 + frame.shape[1]] = frame
        if args.dynamic:
            noise_amp = ce.get_number()
            snr_db = 10 * np.log10((0.05 / (2 * noise_amp)) ** 2)
        else:
            snr_db = args.snr
        p_sig = np.mean(np.abs(frame) ** 2)
        sigma = np.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        x = (x + sigma * (rng.standard_normal(x.shape)
                          + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
        infos = rx.work(x)
        if infos:
            info = infos[0]
            ok = info["payload_valid"] and np.array_equal(
                np.asarray(info["payload"]), payload[0])
            packet_info = {
                "header_valid": 1, "payload_valid": int(ok),
                "modulation": info["modulation"],
                "inner_code": info["inner_code"],
                "outer_code": info["outer_code"],
            }
        else:  # frame lost entirely: report failure on the chosen config
            packet_info = {
                "header_valid": 0, "payload_valid": 0, **cfg_dict,
            }
        new_cfg = ce.handler(packet_info)
        if new_cfg:
            cfg_dict = new_cfg
        r = ce.store.rx_log[-1]
        goodputs.append(r.throughput)
        if (pkt + 1) % 25 == 0:
            window = goodputs[-25:]
            print(f"pkt {pkt+1:4d}: snr={snr_db:5.1f} dB  "
                  f"avg goodput(25)={np.mean(window):.3f} bit/sym  "
                  f"config={cfg_dict}")

    print(f"\nfinal avg goodput (last 50): {np.mean(goodputs[-50:]):.3f} bit/sym")
    ki = ce.store.ki_log
    if ki:
        print(f"knowledge indicators (last): LBI={ki[-1][1]:.3f} RBI={ki[-1][2]:.3f} "
              f"CCI={ki[-1][3]:.3f} CI={ki[-1][4]:.3f}")


if __name__ == "__main__":
    main()
