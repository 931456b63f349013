#!/usr/bin/env python
"""Supervised multi-worker streaming RX demo (SURVEY.md section 5.3).

Spawns N worker processes, each continuously decoding its own channel's
chunked stream with StreamingRx under a heartbeat Supervisor
(runtime/supervisor.py). Each worker checkpoints its stream carry +
decoded-frame tally atomically after every chunk; with --kill, one worker
os._exit()s mid-stream and the supervisor respawns it, after which it
resumes from the checkpoint with exactly-once accounting (a frame
straddling the crash point — its head living only in the checkpointed
carry — still decodes exactly once).

Usage:
    python apps/supervised_rx_demo.py --cpu --workers 2 --chunks 6 --kill 0
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liquiddsp_tpu.runtime.supervisor import Supervisor, WorkerSpec  # noqa: E402

# Workers run on the CPU on purpose: several share one machine, and each
# JAX process on a GPU would need a card of its own.
WORKER = r"""
import json, os, sys

sys.path.insert(0, sys.argv[5])
from liquiddsp_tpu.utils.init import init_device

init_device(cpu=True)
import jax
import numpy as np
import jax.numpy as jnp
from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.phy import framegen
from liquiddsp_tpu.runtime.stream import StreamingRx
from liquiddsp_tpu.runtime.supervisor import Heartbeat, load_stream_state, save_stream_state

work_dir, widx, n_chunks, die_after = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
)
hb = Heartbeat(os.path.join(work_dir, f"hb{widx}"))
ckpt = os.path.join(work_dir, f"state{widx}.npz")

cfg = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
chunk = 2048
rng = np.random.default_rng(1000 + widx)
payloads = rng.integers(0, 256, (n_chunks, 64), dtype=np.uint8)
frames = np.asarray(framegen.framegen(jnp.asarray(payloads), cfg))
f = frames.shape[1]
stream = np.zeros((1, n_chunks * chunk), dtype=np.complex64)
starts = [300] + [chunk * (i + 1) - f // 2 for i in range(n_chunks - 1)]
for s, fr in zip(starts, frames):
    stream[0, s : s + f] = fr
sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** 2.0))
stream += sigma * (
    rng.standard_normal(stream.shape) + 1j * rng.standard_normal(stream.shape)
).astype(np.complex64)

rx = StreamingRx(cfg, batch=1, chunk_len=chunk)
extra = load_stream_state(ckpt, rx)
decoded = [int(s) for s in extra["decoded"]] if extra else []
resumed = extra is not None

while (i := rx._samples_consumed // chunk) < n_chunks:
    hb.beat()
    res = rx.step(jnp.asarray(stream[:, i * chunk : (i + 1) * chunk]))
    m = np.asarray(res.mask)[0]
    for k in np.nonzero(m)[0]:
        if bool(np.asarray(res.payload_valid)[0, k]):
            decoded.append(rx.start_epoch + int(np.asarray(res.start)[0, k]))
    save_stream_state(ckpt, rx, decoded=np.asarray(decoded, dtype=np.int64))
    if die_after >= 0 and i + 1 == die_after and not os.path.exists(
        os.path.join(work_dir, f"died{widx}")
    ):
        open(os.path.join(work_dir, f"died{widx}"), "w").write("1")
        print(f"worker {widx}: simulated crash after chunk {i}", flush=True)
        os._exit(9)

json.dump(
    {"decoded": sorted(decoded), "expected": sorted(starts), "resumed": resumed},
    open(os.path.join(work_dir, f"tally{widx}.json"), "w"),
)
print(f"worker {widx}: done, {len(decoded)}/{len(starts)} frames"
      + (" (resumed from checkpoint)" if resumed else ""))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="(workers always run CPU)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--kill", type=int, default=-1,
                    help="worker index to crash once mid-stream (-1: none)")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    events = []
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as fh:
            fh.write(WORKER)
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        specs = [
            WorkerSpec(
                name=f"rx{w}",
                argv=[sys.executable, script, td, str(w), str(args.chunks),
                      str(args.chunks // 2 if w == args.kill else -1), repo],
                heartbeat_path=os.path.join(td, f"hb{w}"),
                stale_after_s=120.0,
                max_restarts=2,
            )
            for w in range(args.workers)
        ]
        sup = Supervisor(
            specs,
            on_event=lambda n, ev, d: (
                events.append((n, ev)), print(f"[supervisor] {n}: {ev} ({d})")
            ),
            env=env,
        )
        sup.start()
        summary = sup.run(poll_interval_s=0.25, timeout_s=900)
        total = ok = 0
        for w in range(args.workers):
            tally = json.load(open(os.path.join(td, f"tally{w}.json")))
            match = sum(
                1 for s in tally["expected"]
                if any(abs(s - g) <= 1 for g in tally["decoded"])
            )
            dup = len(tally["decoded"]) - len(set(tally["decoded"]))
            total += len(tally["expected"])
            ok += match
            print(f"worker {w}: {match}/{len(tally['expected'])} frames, "
                  f"{dup} duplicates, resumed={tally['resumed']}")
            assert dup == 0, "exactly-once violated"
        print(f"total: {ok}/{total} frames decoded exactly once; "
              f"restarts={[s['restarts'] for s in summary]}")
        assert ok == total


if __name__ == "__main__":
    main()
