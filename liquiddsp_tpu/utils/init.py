"""Device start-up for the command-line entry points.

``init_device`` is the one start-up path of ``bench.py``, ``chip_smoke.py``
and the scripts under ``apps/``, ``bench/`` and ``tools/``. It

- keeps JAX's persistent compile cache in ``JAX_COMPILATION_CACHE_DIR``
  when that is set (JAX reads it itself), else in ``<repo>/.jax_cache``;
- requires a CUDA GPU, unless the caller asks for the CPU explicitly;
- returns and prints what the program runs on: JAX's platform, device kind
  and device count, and the card's name and power limit as ``nvidia-smi``
  reports them.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def card_info() -> dict:
    """The first card's name and power limit, read by ``nvidia-smi`` in a
    child process (which does not touch JAX)."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()
    name, limit = (f.strip() for f in out.splitlines()[0].split(",", 1))
    return {"card_name": name, "power_limit": limit, "nvidia_smi": out}


def init_device(cpu: bool = False) -> dict:
    """Start JAX on a GPU (or on the CPU when ``cpu``); raise SystemExit if
    no GPU is found. Call before any other JAX work in the process."""
    if cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
    }
    if not cpu:
        if info["platform"] != "gpu":
            raise SystemExit(
                f"no GPU: JAX found {info['platform']} "
                f"({info['device_kind']}); pass --cpu to run on the CPU"
            )
        info.update(card_info())
        print(info["nvidia_smi"], flush=True)
    print("device:", json.dumps(info), flush=True)
    return info
