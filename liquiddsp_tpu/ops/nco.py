"""Numerically-controlled oscillator: mixing / derotation, batched.

liquid's flexframesync uses an NCO to remove the estimated carrier offset
before symbol recovery (SURVEY.md section 2.2). Here a mix is a closed-form
phase ramp (no per-sample recursion): exp(-j(dphi*n + phi)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mix_down(x: jax.Array, dphi, phi=0.0):
    """Derotate [..., T] by carrier dphi (rad/sample) and phase phi.

    dphi/phi may be scalars or [...]-shaped per-row estimates."""
    t = x.shape[-1]
    n = jnp.arange(t, dtype=jnp.float32)
    dphi = jnp.asarray(dphi, dtype=jnp.float32)[..., None]
    phi = jnp.asarray(phi, dtype=jnp.float32)[..., None]
    return x * jnp.exp(-1j * (dphi * n + phi))


def mix_up(x: jax.Array, dphi, phi=0.0):
    return mix_down(x, jnp.negative(dphi), jnp.negative(phi))


def pll_track(symbols: jax.Array, reference: jax.Array, bw: float = 0.02):
    """Decision-directed second-order PLL over a symbol stream (lax.scan).

    symbols/reference: [B, N]. Returns (corrected, phase_trajectory).
    The batched analog of liquid's nco_crcf_pll_step; used for long-frame
    residual tracking experiments (framesync's default is the closed-form
    header-pilot refinement in phy/framesync.py).
    """
    alpha = bw
    beta = 0.25 * bw * bw

    def step(carry, xs):
        phase, freq = carry
        sym, ref = xs
        corrected = sym * jnp.exp(-1j * phase)
        err = jnp.angle(corrected * jnp.conj(ref))
        freq = freq + beta * err
        phase = phase + freq + alpha * err
        return (phase, freq), (corrected, phase)

    b = symbols.shape[0]
    init = (jnp.zeros(b), jnp.zeros(b))
    _, (out, traj) = jax.lax.scan(
        step, init, (jnp.moveaxis(symbols, 1, 0), jnp.moveaxis(reference, 1, 0))
    )
    return jnp.moveaxis(out, 0, 1), jnp.moveaxis(traj, 0, 1)
