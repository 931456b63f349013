"""Fused multi-template preamble correlator (detect stage).

The hot loop of frame detection (SURVEY.md section 3.4: per-sample
``qdetector_cccf_execute`` in the reference; here the whole block at once).
For every lag t it computes

    c_f[t] = sum_n x[t+n] * conj(s_f[n])        (F templates, L = 128 taps)
    E[t]   = sum_n |x[t+n]|^2
    rho2[t] = max_f |c_f[t]|^2 / (E_s * E[t])

and returns only the reduced per-lag quantities (rho2, argmax bin, peak
correlation, energy).

Block-Toeplitz formulation: the stream is cut into L-sample blocks; all L
lags of block k come from [X_k | X_{k+1}] @ M with M the stacked
lower/upper Toeplitz template matrices (``_toeplitz_mats``). Three
implementations share that contract:

- ``correlate_reduced_triton``: a Pallas kernel through Triton. Each
  program takes NBT lag-blocks of one batch row and LT lags of each,
  loops over the F templates with a running max/argmax, and writes only
  the reduced rows, so the [B, NB, F*L] surface never reaches device
  memory. Operands are bf16 with f32 accumulation.
- ``correlate_reduced_mm``: the same matmuls in plain XLA (the reference
  for the kernel, and the plain path off the GPU).
- ``correlate_reduced_xla``: the FFT overlap-save correlator
  (phy/detector.correlate).

``correlate_reduced`` picks the kernel on a GPU and ``mm`` elsewhere
(kernels.choose).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from liquiddsp_tpu.kernels import choose

NBT = 64  # lag-blocks (of L lags each) per program
LT = 64  # lags of each block per program
NUM_WARPS = 4

# bf16 operands round each product to ~8 significant bits; with f32
# accumulation the reduced rho2/corr stay within ~2e-2 relative of the f32
# path, far below the detector's operating SNR (tests/test_kernels.py)
BF16_RTOL = 2e-2


@functools.lru_cache(maxsize=None)
def _toeplitz_mats(key: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Block-Toeplitz template matrices for the matmul correlator.

    For block length L (= template length) and lag o within a block, the
    window starting at k*L+o spans signal blocks k and k+1:

        c[k*L+o] = sum_i A[i]*conj(s[i-o])   (i >= o;   A = block k)
                 + sum_j B[j]*conj(s[L+j-o]) (j <  o;   B = block k+1)

    so c_block = [A | B] @ M with M[0:L] lower-Toeplitz and M[L:2L]
    upper-Toeplitz in conj(s). Returns (Mr, Mi) [2L, F*L] float32 packed
    over templates, plus the all-ones energy Toeplitz [2L, L]."""
    templates = _TEMPLATE_CACHE[key]
    f, l = templates.shape
    m = np.zeros((2 * l, f, l), dtype=np.complex64)
    for fi in range(f):
        cs = np.conj(templates[fi])
        for o in range(l):
            m[o:l, fi, o] = cs[: l - o]
            m[l : l + o, fi, o] = cs[l - o :]
    m = m.reshape(2 * l, f * l)
    e = np.zeros((2 * l, l), dtype=np.float32)
    for o in range(l):
        e[o:l, o] = 1.0
        e[l : l + o, o] = 1.0
    return (
        np.real(m).astype(np.float32),
        np.imag(m).astype(np.float32),
        e,
    )


_TEMPLATE_CACHE: dict[tuple, np.ndarray] = {}


def _template_key(templates: np.ndarray) -> tuple:
    # keyed on raw bytes + shape + dtype (not a lossy int hash): a hash
    # collision between different template sets must not alias cache entries
    key = (templates.tobytes(), templates.shape, str(templates.dtype))
    _TEMPLATE_CACHE[key] = templates
    return key


def _triton_kernel(xr_ref, xi_ref, mr_ref, mi_ref, nmi_ref, em_ref,
                   rho_o, fb_o, cre_o, cim_o, en_o, *, f: int, inv_es: float):
    """One program: lags [j*LT, (j+1)*LT) of lag-blocks [i*NBT, (i+1)*NBT)
    of batch row b. Matrix refs are [2, F, L, L] (top/bottom Toeplitz half
    x template); the two signal blocks of each lag-block are rows k and k+1
    of the [B, NB+1, L] planes."""
    b, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    rows0 = pl.ds(i * NBT, NBT)
    rows1 = pl.ds(i * NBT + 1, NBT)
    cols = pl.ds(j * LT, LT)
    a0r, a1r = xr_ref[b, rows0, :], xr_ref[b, rows1, :]  # [NBT, L] bf16
    a0i, a1i = xi_ref[b, rows0, :], xi_ref[b, rows1, :]

    def dot(a, m_ref, half, fi):
        return jnp.dot(a, m_ref[half, fi, :, cols],
                       preferred_element_type=jnp.float32)

    def power(ar, ai):
        # squares in f32; the bf16 cast before the 0/1 Toeplitz contraction
        # is the stated per-term rounding (BF16_RTOL)
        ar, ai = ar.astype(jnp.float32), ai.astype(jnp.float32)
        return (ar * ar + ai * ai).astype(a0r.dtype)

    en = dot(power(a0r, a0i), em_ref, 0, 0) + dot(power(a1r, a1i), em_ref, 1, 0)
    best = fb = cbr = cbi = None
    for fi in range(f):
        # (xr + j xi) @ (Mr + j Mi) over both halves
        cr = (dot(a0r, mr_ref, 0, fi) + dot(a1r, mr_ref, 1, fi)
              + dot(a0i, nmi_ref, 0, fi) + dot(a1i, nmi_ref, 1, fi))
        ci = (dot(a0r, mi_ref, 0, fi) + dot(a1r, mi_ref, 1, fi)
              + dot(a0i, mr_ref, 0, fi) + dot(a1i, mr_ref, 1, fi))
        mag2 = cr * cr + ci * ci
        if fi == 0:
            best, fb, cbr, cbi = mag2, jnp.zeros(mag2.shape, jnp.int32), cr, ci
        else:
            upd = mag2 > best  # strict: ties keep the lower bin, as argmax
            best = jnp.where(upd, mag2, best)
            fb = jnp.where(upd, fi, fb)
            cbr = jnp.where(upd, cr, cbr)
            cbi = jnp.where(upd, ci, cbi)
    rho_o[...] = best * inv_es / jnp.maximum(en, 1e-12)
    fb_o[...] = fb
    cre_o[...] = cbr
    cim_o[...] = cbi
    en_o[...] = en


@functools.partial(jax.jit, static_argnames=("es", "interpret"))
def _run_triton(xr, xi, mats, es, *, interpret: bool):
    b, nb1, l = xr.shape
    nb = nb1 - 1
    f = mats[0].shape[1]
    ospec = pl.BlockSpec((None, NBT, LT), lambda bi, i, j: (bi, i, j))
    full = lambda a: pl.BlockSpec(a.shape, lambda bi, i, j: (0,) * a.ndim)
    oshape = lambda dt: jax.ShapeDtypeStruct((b, nb, l), dt)
    kernel = functools.partial(_triton_kernel, f=f, inv_es=float(1.0 / es))
    return pl.pallas_call(
        kernel,
        grid=(b, nb // NBT, l // LT),
        in_specs=[full(xr), full(xi)] + [full(m) for m in mats],
        out_specs=[ospec] * 5,
        out_shape=[oshape(jnp.float32), oshape(jnp.int32)]
        + [oshape(jnp.float32)] * 3,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="correlate_reduced",
    )(xr, xi, *mats)


@functools.lru_cache(maxsize=None)
def _triton_mats(key: tuple, dtype) -> tuple[np.ndarray, ...]:
    """(Mr, Mi, -Mi, E) split into top/bottom halves per template:
    [2, F, L, L] each (E has F = 1)."""
    mr, mi, em = _toeplitz_mats(key)
    l2, fl = mr.shape
    l = l2 // 2
    f = fl // l
    per_t = lambda m: m.reshape(2, l, f, l).transpose(0, 2, 1, 3)
    return tuple(
        np.ascontiguousarray(a).astype(dtype)
        for a in (per_t(mr), per_t(mi), per_t(-mi), em.reshape(2, 1, l, l))
    )


def correlate_reduced_triton(
    x: jax.Array, templates: np.ndarray, interpret: bool = False
):
    """x [B, T] complex64, templates [F, L] complex -> dict of [B, T] arrays:
    rho2, fbin (int32), corr (complex64), energy. Fused Pallas kernel
    (Triton route), bf16 operands with f32 accumulation."""
    f, l = templates.shape
    b, t = x.shape
    assert l % LT == 0, (l, LT)
    es = float(np.sum(np.abs(templates[0]) ** 2))
    mats = tuple(
        jnp.asarray(m)
        for m in _triton_mats(_template_key(templates), jnp.bfloat16)
    )
    nb = -(-t // l)
    nb = -(-nb // NBT) * NBT  # whole programs
    pad = (nb + 1) * l - t
    planes = [
        jnp.pad(p.astype(jnp.bfloat16), ((0, 0), (0, pad))).reshape(b, nb + 1, l)
        for p in (jnp.real(x), jnp.imag(x))
    ]
    outs = _run_triton(*planes, mats, es, interpret=interpret)
    rho2, fb, cre, cim, en = (o.reshape(b, nb * l)[:, :t] for o in outs)
    return {
        "rho2": rho2,
        "fbin": fb,
        "corr": jax.lax.complex(cre, cim),
        "energy": en,
    }


def correlate_reduced_mm(
    x: jax.Array, templates: np.ndarray, dtype: jnp.dtype = jnp.float32
):
    """Plain-XLA block-Toeplitz correlator, same contract as
    ``correlate_reduced_triton``: the [B, T] stream is cut into L-sample
    blocks and all F correlations for a block of lags come from one
    [NB, 2L] x [2L, F*L] matmul. Energy uses the same structure with an
    all-ones Toeplitz, so there is no cumsum scan anywhere. ``dtype`` is
    the matmul operand type; accumulation is f32 either way.
    """
    f, l = templates.shape
    b, t = x.shape
    es = float(np.sum(np.abs(templates[0]) ** 2))
    mr_np, mi_np, em_np = _toeplitz_mats(_template_key(templates))
    nb = -(-t // l)
    pad = (nb + 1) * l - t
    xr = jnp.pad(jnp.real(x).astype(dtype), ((0, 0), (0, pad)))
    xi = jnp.pad(jnp.imag(x).astype(dtype), ((0, 0), (0, pad)))
    xr = xr.reshape(b, nb + 1, l)
    xi = xi.reshape(b, nb + 1, l)
    xr_cat = jnp.concatenate([xr[:, :nb], xr[:, 1:]], axis=-1)  # [B, NB, 2L]
    xi_cat = jnp.concatenate([xi[:, :nb], xi[:, 1:]], axis=-1)
    mr = jnp.asarray(mr_np, dtype)
    mi = jnp.asarray(mi_np, dtype)
    mm = functools.partial(jnp.einsum, "bnk,kf->bnf",
                           preferred_element_type=jnp.float32)
    # c = (xr + j xi) @ (Mr + j Mi)
    cr = mm(xr_cat, mr) - mm(xi_cat, mi)
    ci = mm(xr_cat, mi) + mm(xi_cat, mr)
    cr = cr.reshape(b, nb, f, l)
    ci = ci.reshape(b, nb, f, l)
    mag2 = cr * cr + ci * ci  # [B, NB, F, L]
    best = jnp.argmax(mag2, axis=2).astype(jnp.int32)  # [B, NB, L]
    m2 = jnp.max(mag2, axis=2)
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, mag2.shape, 2) == best[:, :, None, :]
    )
    cb_re = jnp.sum(jnp.where(onehot, cr, 0.0), axis=2)
    cb_im = jnp.sum(jnp.where(onehot, ci, 0.0), axis=2)
    xr_f, xi_f = xr_cat.astype(jnp.float32), xi_cat.astype(jnp.float32)
    p_cat = (xr_f * xr_f + xi_f * xi_f).astype(dtype)
    energy = mm(p_cat, jnp.asarray(em_np, dtype))  # [B, NB, L]
    rho2 = m2 / (es * jnp.maximum(energy, 1e-12))
    flat = lambda a: a.reshape(b, nb * l)[:, :t]
    return {
        "rho2": flat(rho2),
        "fbin": flat(best),
        "corr": jax.lax.complex(flat(cb_re), flat(cb_im)),
        "energy": flat(energy),
    }


def correlate_reduced_xla(x: jax.Array, templates: np.ndarray):
    """Equivalent XLA fallback built on the FFT overlap-save correlator."""
    from liquiddsp_tpu.phy import detector as det

    corr, energy = det.correlate(x)  # corr [B, F, T]
    es = float(np.sum(np.abs(templates[0]) ** 2))
    mag2 = jnp.abs(corr) ** 2
    fbin = jnp.argmax(mag2, axis=1).astype(jnp.int32)  # [B, T]
    m2 = jnp.max(mag2, axis=1)
    rho2 = m2 / (es * jnp.maximum(energy, 1e-12))
    cbest = jnp.take_along_axis(corr, fbin[:, None, :], axis=1)[:, 0]
    return {"rho2": rho2, "fbin": fbin, "corr": cbest, "energy": energy}


def correlate_reduced(
    x: jax.Array, templates: np.ndarray, backend: str | None = None
):
    """Dispatch: ``"triton"`` (the fused kernel; the default on a GPU),
    ``"triton_interpret"`` (the same kernel in Pallas interpret mode),
    ``"mm"`` (plain block-Toeplitz matmuls in f32; the default elsewhere)
    or ``"fft"`` (overlap-save FFT)."""
    backend = choose(backend, "triton", "mm")
    if backend == "triton":
        return correlate_reduced_triton(x, templates)
    if backend == "triton_interpret":
        return correlate_reduced_triton(x, templates, interpret=True)
    if backend == "mm":
        return correlate_reduced_mm(x, templates)
    if backend == "fft":
        return correlate_reduced_xla(x, templates)
    raise ValueError(f"unknown correlator backend {backend!r}")
