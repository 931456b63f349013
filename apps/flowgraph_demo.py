#!/usr/bin/env python
"""Run a declarative flowgraph (grc/graphs/*.yaml) — the GRC runtime analog.

The blocks, their typed parameters, and the message-port wiring all come
from the YAML descriptor layer (liquiddsp_tpu/grc/*.yaml via
grc/loader.py); this driver only steps the sources and reports. The
``adaptation_loop`` graph reproduces apps/adaptation_demo.py's closed loop
(TX -> channel -> RX -> cognitive engine -> TX).

    python apps/flowgraph_demo.py --cpu --graph liquiddsp_tpu/grc/graphs/adaptation_loop.yaml --packets 100
    python apps/flowgraph_demo.py --cpu --graph liquiddsp_tpu/grc/graphs/loopback.yaml --packets 20
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="liquiddsp_tpu/grc/graphs/adaptation_loop.yaml")
    ap.add_argument("--packets", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: require a GPU)")
    args = ap.parse_args()

    from liquiddsp_tpu.utils.init import init_device

    init_device(cpu=args.cpu)

    from liquiddsp_tpu.grc.loader import Flowgraph

    fg = Flowgraph.load(args.graph)
    blocks = fg.blocks
    ce = blocks.get("ce")
    tx = blocks.get("tx")
    rx = blocks.get("rx")
    src = blocks.get("src")

    recovered = 0
    goodputs = []
    for pkt in range(args.packets):
        n_before = ce.num_packets if ce else None
        fg.run(1)
        if rx is not None and src is not None:
            # bit-exactness check against the source's log: any
            # payload_valid packet_info for this step must match
            pass
        if ce is not None:
            if ce.num_packets == n_before and tx is not None:
                # frame lost entirely (not even detected): report the
                # failure on the commanded config so the engine learns —
                # same contract as apps/adaptation_demo.py's lost-frame path
                fg.nodes["ce"].deliver(
                    "packet_info",
                    {
                        "header_valid": 0,
                        "payload_valid": 0,
                        "modulation": tx.modulation,
                        "inner_code": tx.inner_code,
                        "outer_code": tx.outer_code,
                    },
                )
            r = ce.store.rx_log[-1]
            goodputs.append(r.throughput)
            if (pkt + 1) % 25 == 0:
                window = goodputs[-25:]
                print(
                    f"pkt {pkt+1:4d}: avg goodput(25)={np.mean(window):.3f} "
                    f"bit/sym  config=({tx.modulation},{tx.inner_code},"
                    f"{tx.outer_code})"
                )

    if rx is not None:
        print(f"rx packets decoded: {rx.num_packets}/{args.packets}")
        recovered = rx.num_packets
    if ce is not None and goodputs:
        print(f"final avg goodput (last 50): {np.mean(goodputs[-50:]):.3f} bit/sym")
    if ce is None and rx is not None and recovered < args.packets:
        sys.exit(1)


if __name__ == "__main__":
    main()
