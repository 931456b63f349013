"""Batched FIR filtering: interpolation (TX), matched filtering (RX).

Replaces liquid-dsp's scalar per-sample interp/decim inside
``flexframegen_write_samples`` / ``flexframesync_execute``
(SURVEY.md section 2.2, filter/interp row) with whole-block convolutions that
XLA lowers to batched convolutions. Taps are real (RRC family), signals complex64:
a complex-by-real convolution is two real convolutions.

Conventions (shared by phy/framegen and phy/framesync):
- ``interp_full(syms, h, k)``: zero-stuff by k then 'full' convolution.
  Output length = k*n + len(h) - 1.
- ``conv_full(x, h)``: 'full' linear convolution, length T + len(h) - 1.
- After TX interp + RX matched filter, symbol i sits at sample
  ``k*i + (len(h) - 1)`` of the RX output when the RX input starts exactly at
  the TX frame start.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _conv1d(x: jax.Array, h: jax.Array, pad_l: int, pad_r: int, lhs_dilation: int = 1) -> jax.Array:
    """Real 1-D convolution (true convolution, kernel flipped) over last axis.

    x: [..., T] float32. h: [L] float32. Returns [..., T_out].
    """
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    lhs = x.reshape((-1, 1, t))
    rhs = h[::-1].reshape((1, 1, -1))
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=((pad_l, pad_r),),
        lhs_dilation=(lhs_dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
    )
    return out.reshape(batch_shape + (out.shape[-1],))


def conv_full(x: jax.Array, h: np.ndarray | jax.Array) -> jax.Array:
    """'full' convolution of complex [..., T] with real taps [L] -> [..., T+L-1]."""
    h = jnp.asarray(h, dtype=jnp.float32)
    pad = h.shape[0] - 1
    if jnp.iscomplexobj(x):
        re = _conv1d(jnp.real(x), h, pad, pad)
        im = _conv1d(jnp.imag(x), h, pad, pad)
        return (re + 1j * im).astype(jnp.complex64)
    return _conv1d(x, h, pad, pad)


def conv_same(x: jax.Array, h: np.ndarray | jax.Array) -> jax.Array:
    """'same' convolution: output aligned with input, length T."""
    h = jnp.asarray(h, dtype=jnp.float32)
    l = h.shape[0]
    pad_l = (l - 1) // 2
    pad_r = l - 1 - pad_l
    if jnp.iscomplexobj(x):
        re = _conv1d(jnp.real(x), h, pad_l, pad_r)
        im = _conv1d(jnp.imag(x), h, pad_l, pad_r)
        return (re + 1j * im).astype(jnp.complex64)
    return _conv1d(x, h, pad_l, pad_r)


def interp_full(syms: jax.Array, h: np.ndarray | jax.Array, k: int) -> jax.Array:
    """Zero-stuff complex symbols [..., n] by k, 'full'-convolve with taps [L].

    Output [..., k*n + L - 1]: the TX pulse-shaping interpolator
    (liquid ``firinterp`` analog inside flexframegen).
    """
    h = jnp.asarray(h, dtype=jnp.float32)
    l = h.shape[0]
    # dilated length (n-1)*k+1; pad to cover full support incl. trailing zeros
    pad_l = l - 1
    pad_r = l - 1 + (k - 1)
    re = _conv1d(jnp.real(syms), h, pad_l, pad_r, lhs_dilation=k)
    im = _conv1d(jnp.imag(syms), h, pad_l, pad_r, lhs_dilation=k)
    return (re + 1j * im).astype(jnp.complex64)


def matched_filter_decimate(
    x: jax.Array, h: np.ndarray | jax.Array, k: int, offset: int
) -> jax.Array:
    """Matched-filter then take every k-th sample starting at ``offset``.

    x: [..., T] complex aligned so the first symbol's pulse center lands at
    sample ``offset`` of the 'full'-convolved output (= len(h)-1 when x starts
    at the frame start).
    """
    y = conv_full(x, h)
    return y[..., offset::k]
