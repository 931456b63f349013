"""Observability: per-stage link metrics + profiler hooks.

The reference's diagnostics are bare std::cout / print statements
(SURVEY.md section 5.1: detection counts at lib/frame_detector_cc_impl.cc:79,
CE traces at python/cognitive_engine.py:92-94, 797), plus the sqlite tx/rx
decision logs and the unused per-config receive counters at
lib/flex_rx_impl.h:56-57. This module provides the structured replacement:

- ``LinkMetrics``: per-block device-side counters (frames detected / header
  ok / payload ok, goodput, EVM) computed inside the jitted step and
  reducible across the mesh with psum — one scalar bundle per block, no
  per-frame host chatter.
- ``MetricsCollector``: host-side accumulator with per-config receive
  counters (the [11,7,8] arrays the reference allocates but never uses —
  here they work) and rate reporting.
- ``profile_trace``: context manager around jax.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.core.config import (
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LinkMetrics:
    """Device-side per-block counters (jit/psum friendly)."""

    samples: jax.Array  # scalar int32
    frames_detected: jax.Array
    headers_valid: jax.Array
    payloads_valid: jax.Array
    sum_evm_db: jax.Array  # over header-valid frames
    sum_rssi_db: jax.Array

    @staticmethod
    def from_results(res, samples: int) -> "LinkMetrics":
        hv = res.header_valid
        return LinkMetrics(
            samples=jnp.int32(samples),
            frames_detected=jnp.sum(res.mask.astype(jnp.int32)),
            headers_valid=jnp.sum(hv.astype(jnp.int32)),
            payloads_valid=jnp.sum(res.payload_valid.astype(jnp.int32)),
            sum_evm_db=jnp.sum(jnp.where(hv, res.evm, 0.0)),
            sum_rssi_db=jnp.sum(jnp.where(hv, res.rssi, 0.0)),
        )

    def psum(self, axes) -> "LinkMetrics":
        """Aggregate across mesh axes (inside shard_map)."""
        return jax.tree.map(lambda v: jax.lax.psum(v, axes), self)


class MetricsCollector:
    """Host-side accumulator + per-config receive counters."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.samples = 0
        self.frames_detected = 0
        self.headers_valid = 0
        self.payloads_valid = 0
        self.sum_evm_db = 0.0
        # the per-config counters flex_rx initializes but never uses
        # (lib/flex_rx_impl.h:56-57) — functional here
        shape = (NUM_MODULATIONS, NUM_INNER_CODES, NUM_OUTER_CODES)
        self.num_received = np.zeros(shape, dtype=np.int64)
        self.num_correct = np.zeros(shape, dtype=np.int64)

    def update(self, m: LinkMetrics):
        self.samples += int(m.samples)
        self.frames_detected += int(m.frames_detected)
        self.headers_valid += int(m.headers_valid)
        self.payloads_valid += int(m.payloads_valid)
        self.sum_evm_db += float(m.sum_evm_db)

    def count_packet(self, modulation: int, inner: int, outer: int, payload_valid: bool):
        self.num_received[modulation, inner, outer] += 1
        if payload_valid:
            self.num_correct[modulation, inner, outer] += 1

    def report(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "samples": self.samples,
            "samples_per_sec": self.samples / dt,
            "frames_detected": self.frames_detected,
            "headers_valid": self.headers_valid,
            "payloads_valid": self.payloads_valid,
            "frame_success_rate": (
                self.payloads_valid / self.frames_detected if self.frames_detected else 0.0
            ),
            "mean_evm_db": (
                self.sum_evm_db / self.headers_valid if self.headers_valid else 0.0
            ),
            "elapsed_s": dt,
        }


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """jax.profiler trace scope (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
