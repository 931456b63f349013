#!/usr/bin/env python
"""Benchmark: aggregate RX throughput (samples/s per card) on one GPU.

Two configs are timed through the full framesync path (detection + candidate
extraction + header decode + payload decode) over a 64-channel stream:

- "nofec": QPSK, no FEC, ~20 dB SNR — BASELINE configs 1+3 rolled into the
  headline metric "RX samples/s per card".
- "fec": QPSK + V27 (K=7 conv, soft Viterbi) + Golay(24,12), ~10 dB SNR —
  the full decode chain the reference drives at lib/flex_rx_impl.cc:213
  (deinterleave -> Viterbi -> Golay -> CRC), with the Viterbi kernel
  (kernels/viterbi.py) inside the timed region.

plus the streaming (per-chunk, superstep, occupancy-adaptive) and
per-channel-resampled paths. Every config asserts that it decodes the
expected frame count, bit-exactly. The stream is synthesized on the device
inside jit and only integer counts return to the host.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}, where
value is the no-FEC headline, device names the platform, device kind,
device count and the card's name and power limit, and extra.configs
carries the full per-config results.

Run: ``python bench.py`` (one GPU; fails without one).
"""

import json
import sys

sys.path.insert(0, ".")


def main():
    from liquiddsp_tpu.utils.init import init_device

    device = init_device()
    import jax
    import jax.numpy as jnp

    from bench import cells
    from liquiddsp_tpu.core.config import FrameConfig

    qpsk = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
    results = {
        "nofec": cells.bench_config(jax, jnp, qpsk, snr_db=20.0),
        # full decode chain: deinterleave -> soft Viterbi -> Golay -> CRC24,
        # at an SNR where the FEC is doing real work
        "fec": cells.bench_config(
            jax, jnp, FrameConfig(modulation=1, inner_code=1, outer_code=1,
                                  payload_len=64), snr_db=10.0
        ),
        # continuous operation: chunked StreamingRx with overlap carry
        "streaming": cells.bench_streaming(jax, jnp, qpsk, snr_db=20.0),
        # BASELINE config 3 fidelity: 64 channels WITH per-channel
        # polyphase resampling (4 ppm groups spanning +-50 ppm; identical
        # FLOP cost to 64 distinct ratios — ops/resample.arbitrary
        # compiles per static rate) inside the timed region
        "resampled": cells.bench_resampled(jax, jnp, qpsk, snr_db=20.0),
    }

    head = results["nofec"]
    print(
        json.dumps(
            {
                "metric": "rx_samples_per_sec",
                "value": head["samples_per_sec"],
                "unit": "samples/s",
                "device": device,
                "extra": {
                    "fec_samples_per_sec": results["fec"]["samples_per_sec"],
                    "streaming_samples_per_sec": results["streaming"][
                        "samples_per_sec"
                    ],
                    "streaming_adaptive_samples_per_sec": results["streaming"][
                        "adaptive_samples_per_sec"
                    ],
                    "resampled_samples_per_sec": results["resampled"][
                        "samples_per_sec"
                    ],
                    "configs": results,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
