"""Automatic gain control, batched.

liquid's flexframesync runs a per-sample AGC in front of detection
(SURVEY.md section 2.2 AGC/NCO/symbol-sync row). Block-dense version:

- ``agc_block``: one gain per block (RMS normalize) — what the detector's
  energy normalization already implies; exposed for pipeline use.
- ``agc_windowed``: sliding-window RMS gain, fully parallel (cumsum), the
  batched analog of a per-sample tracking loop for slowly varying levels.
- ``agc_scan``: faithful first-order tracking loop (attack/decay bandwidth
  alpha) as a ``lax.scan`` — for parity experiments where loop dynamics
  matter; O(T) sequential, prefer the windowed form on an accelerator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def agc_block(x: jax.Array, target_rms: float = 1.0, eps: float = 1e-12):
    """[..., T] -> (normalized, gain[...]): one gain per trailing axis."""
    rms = jnp.sqrt(jnp.mean(jnp.abs(x) ** 2, axis=-1) + eps)
    gain = target_rms / rms
    return x * gain[..., None], gain


def agc_windowed(x: jax.Array, window: int = 256, target_rms: float = 1.0,
                 eps: float = 1e-12):
    """Sliding-RMS gain: [..., T] -> (y, gain [..., T]). Causal window."""
    p = jnp.abs(x) ** 2
    cs = jnp.cumsum(p, axis=-1)
    csp = jnp.pad(cs, [(0, 0)] * (x.ndim - 1) + [(window, 0)])
    win_sum = cs - csp[..., :-window][..., : cs.shape[-1]]
    n = jnp.minimum(jnp.arange(1, x.shape[-1] + 1), window)
    rms = jnp.sqrt(win_sum / n + eps)
    gain = target_rms / jnp.maximum(rms, eps)
    return x * gain, gain


def agc_scan(x: jax.Array, alpha: float = 0.01, target_rms: float = 1.0,
             eps: float = 1e-12):
    """First-order tracking AGC (liquid agc_crcf-style loop) via lax.scan.

    x: [B, T]. Returns (y, gain [B, T])."""

    def step(g, xt):
        y = xt * g
        err = target_rms - jnp.abs(y)
        g_new = g * jnp.exp(alpha * err)
        return g_new, (y, g)

    g0 = jnp.ones(x.shape[:-1], dtype=jnp.float32)
    _, (y, gain) = jax.lax.scan(step, g0, jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(y, 0, -1), jnp.moveaxis(gain, 0, -1)
