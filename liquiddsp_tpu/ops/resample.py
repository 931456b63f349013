"""Polyphase resampling, batched — BASELINE config 3's "per-channel
polyphase resampling" and the liquid firinterp/firdecim/resamp analog.

- ``interp(x, p, taps)``: integer upsampling by P (polyphase FIR).
- ``decim(x, q, taps)``: integer decimation by Q with anti-alias FIR.
- ``rational(x, p, q, taps)``: rational P/Q resampling (polyphase interp
  then decimate — single conv via lhs_dilation + stride).
- ``arbitrary(x, rate, num_phases)``: arbitrary-ratio resampling via a
  fractional-delay polyphase bank: output sample i reads input position
  i/rate with the nearest-of-``num_phases`` fractional filter — a gather +
  windowed dot, fully parallel.
- ``design_lowpass``: windowed-sinc anti-alias prototype.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.ops import fir


@functools.lru_cache(maxsize=None)
def design_lowpass(cutoff: float, ntaps: int = 65) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, unit DC gain. cutoff in (0, 0.5]
    cycles/sample."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(ntaps, 7.0)
    return (h / np.sum(h)).astype(np.float32)


def interp(x: jax.Array, p: int, taps: np.ndarray | None = None) -> jax.Array:
    """[..., T] -> [..., p*T]: zero-stuff + anti-image filter (gain p)."""
    if taps is None:
        taps = design_lowpass(0.5 / p) * p
    y = fir.interp_full(x, jnp.asarray(taps), p)
    delay = (len(taps) - 1) // 2
    return y[..., delay : delay + p * x.shape[-1]]


def decim(x: jax.Array, q: int, taps: np.ndarray | None = None) -> jax.Array:
    """[..., T] -> [..., T//q]: anti-alias filter + take every q-th."""
    if taps is None:
        taps = design_lowpass(0.5 / q)
    y = fir.conv_same(x, jnp.asarray(taps))
    return y[..., ::q]


def rational(x: jax.Array, p: int, q: int, taps: np.ndarray | None = None) -> jax.Array:
    """[..., T] -> [..., (p*T)//q]: resample by rational factor p/q."""
    if taps is None:
        taps = design_lowpass(0.5 / max(p, q)) * p
    up = fir.interp_full(x, jnp.asarray(taps), p)
    delay = (len(taps) - 1) // 2
    up = up[..., delay : delay + p * x.shape[-1]]
    return up[..., ::q]


@functools.lru_cache(maxsize=None)
def _frac_bank(num_phases: int, ntaps: int, cutoff: float) -> np.ndarray:
    """[num_phases, ntaps] fractional-delay low-pass bank (delay p/P)."""
    bank = []
    for ph in range(num_phases):
        n = np.arange(ntaps) - (ntaps - 1) / 2.0 - ph / num_phases
        h = 2 * cutoff * np.sinc(2 * cutoff * n)
        h *= np.kaiser(ntaps, 7.0)
        bank.append(h / np.sum(h))
    return np.asarray(bank, dtype=np.float32)


def _bank_rows(mu: np.ndarray, ntaps: int, cutoff: float) -> np.ndarray:
    """Exact fractional-delay tap rows at arbitrary delays ``mu`` in [0, 1):
    [len(mu), ntaps] (same windowed-sinc family as _frac_bank, no phase
    quantization)."""
    n = np.arange(ntaps)[None, :] - (ntaps - 1) / 2.0 - np.asarray(mu)[:, None]
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h = h * np.kaiser(ntaps, 7.0)[None, :]
    return (h / h.sum(axis=1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bank_lowrank(ntaps: int, cutoff: float, rank: int = 5,
                  fine: int = 1024) -> tuple[np.ndarray, float]:
    """Optimal low-rank factorization of the fractional-delay bank:
    bank(mu)[v] ~= sum_k w_k(mu) H[k, v] with H the top-``rank`` right
    singular vectors (orthonormal rows). Per-position weights are the
    exact projections w(mu) = bank_row(mu) @ H.T, computed at trace time.
    Returns (H [rank, ntaps], max-abs residual over a fine mu grid).

    SVD beats the monomial (classic Farrow) basis plane-for-plane: rank 5
    reaches the residual a degree-6 polynomial needs 7 planes for — and
    the conv planes are the HBM cost of the whole path."""
    bank = _frac_bank(fine, ntaps, cutoff)
    U, s, Vt = np.linalg.svd(bank, full_matrices=False)
    H = Vt[:rank]
    resid = float(np.abs((U[:, :rank] * s[:rank]) @ H - bank).max())
    return H.astype(np.float32), resid


def _lowrank_plan(rate: float, out_len: int, ntaps: int, cutoff: float,
                  H: np.ndarray):
    """Static per-rate index/weight plan for the low-rank path: returns
    (w [out_len, rank] f32, d [out_len] int, segment bounds, Dmax)."""
    pos = np.arange(out_len) / float(rate)
    base = np.floor(pos).astype(np.int64)
    mu = pos - base
    d = base - np.arange(out_len)
    runs = np.nonzero(np.diff(d))[0] + 1
    w = _bank_rows(mu, ntaps, cutoff) @ H.T  # [out_len, rank]
    return (w.astype(np.float32), d, [0, *runs.tolist(), out_len],
            int(abs(d).max()))


def _lowrank_apply(x: jax.Array, plans, H: np.ndarray, ntaps: int,
                   out_len: int, compute_dtype=None) -> jax.Array:
    """Shared low-rank resample core: ONE batched conv of ``x`` with the
    ``rank`` basis filters (z_k = H[k] * x), then per-group static-segment
    combines y[i] = sum_k w[i, k] z_k[i + d[i]]. ``plans`` holds one
    _lowrank_plan per equal contiguous group along axis 0.

    ``compute_dtype=jnp.bfloat16`` runs the conv with bf16
    operands AND stores the rank planes in bf16 — the planes are the HBM
    cost of the whole path, so this nearly halves its traffic for a
    ~-50 dB RMS (-36 dB max) quantization floor (far under any operating
    SNR of the RX front-end; keep f32 for metrology-grade uses)."""
    rank = H.shape[0]
    half = (ntaps - 1) // 2
    Dmax = max(p[3] for p in plans)
    lead = [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, lead + [(half, ntaps + Dmax + 1)])
    bshape = x.shape[:-1]
    cplx = jnp.iscomplexobj(x)
    if cplx:
        xf = jnp.stack([jnp.real(xp), jnp.imag(xp)], axis=0)
    else:
        xf = xp.astype(jnp.float32)[None]
    P = xf.shape[0]
    cdt = compute_dtype or jnp.float32
    z = jax.lax.conv_general_dilated(
        xf.reshape((-1, 1, xf.shape[-1])).astype(cdt),
        jnp.asarray(H)[:, None, :].astype(cdt),
        (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=cdt,
    )  # [P*B, rank, M]; z[:, k, m] = sum_v H[k, v] xp[m + v]
    z = z.reshape((P,) + bshape + z.shape[-2:])
    G = len(plans)
    gsz = x.shape[0] // G if x.ndim > 1 else 1
    groups = []
    for gi, (w, d, bounds, _) in enumerate(plans):
        zg = z[:, gi * gsz : (gi + 1) * gsz] if G > 1 else z
        w_j = jnp.asarray(w)  # [out_len, rank] f32 (combine accumulates f32)
        segs = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            dv = int(d[a])
            acc = zg[..., 0, a + dv : b + dv].astype(jnp.float32) * w_j[a:b, 0]
            for k in range(1, rank):
                acc = acc + (zg[..., k, a + dv : b + dv].astype(jnp.float32)
                             * w_j[a:b, k])
            segs.append(acc)
        groups.append(segs[0] if len(segs) == 1
                      else jnp.concatenate(segs, axis=-1))
    yf = groups[0] if G == 1 else jnp.concatenate(groups, axis=1)
    if cplx:
        return (yf[0] + 1j * yf[1]).astype(x.dtype)
    return yf[0].astype(x.dtype)


def arbitrary(x: jax.Array, rate: float, out_len: int, num_phases: int = 32,
              ntaps: int = 33, compute_dtype=None) -> jax.Array:
    """Arbitrary-ratio resample: y[i] = x(i / rate), [..., T] -> [..., out_len].

    Nearest-phase polyphase interpolation (liquid resamp_crcf analog).
    ``rate`` is STATIC per compile, so the whole index plan (integer base,
    phase row) is computed in numpy at trace time. Near-unity rates (ppm
    clock offsets — BASELINE config 3's per-channel resampling) take a
    fully static formulation: the integer sample offset d = base[i] - i is
    piecewise-constant with at most ~|1-rate|*out_len + 1 runs, so the
    output is a concatenation of statically-sliced segments, each a
    ``ntaps``-term shifted-slice FMA with a constant [seg_len, ntaps] tap
    gather baked in at trace time — no device gathers at all (the gather
    formulation materialized a [.., out_len, ntaps] window tensor: ~16x
    slower than the whole RX at 64x65536, measured r5). Rates far from 1
    (many runs) keep the gather path.
    """
    cutoff = 0.5 * min(1.0, rate)
    bank = _frac_bank(num_phases, ntaps, cutoff)  # numpy [P, ntaps]
    pos = np.arange(out_len) / rate  # input-domain positions (static)
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    phase_r = np.round(frac * num_phases).astype(np.int64)
    base = base + phase_r // num_phases
    phase = phase_r % num_phases
    taps_np = bank[phase]  # [out_len, ntaps] static
    half = (ntaps - 1) // 2
    lead = [(0, 0)] * (x.ndim - 1)

    d = base - np.arange(out_len)  # integer shift per output (static)
    runs = np.nonzero(np.diff(d))[0] + 1
    # The Farrow path's per-segment cost is K+1 static slices, so it stays
    # profitable out to a few hundred integer-shift runs (500 ppm x 65536,
    # where the gather path was the only option); the 33-slice-per-segment
    # stencil fallback stops paying past ~32.
    if len(runs) + 1 <= 256:
        # Near-unity (ppm-rate) fast path: low-rank FARROW structure. The
        # per-tap shifted-slice stencil made ntaps(=33) separate passes
        # over the block in device memory; a rank-r factorization of the fractional-delay
        # bank, bank(mu)[v] ~= sum_k w_k(mu) H[k, v] (SVD basis — reaches
        # a degree-6 polynomial's residual with 5 planes instead of 7),
        # turns it into r FIXED-tap convolutions (ONE conv with r output
        # features = one pass over the input) plus a static per-position
        # weighted combine with the exact per-output fractional delay —
        # which also REMOVES the nearest-of-num_phases quantization. The
        # factorization and its residual are trace-time numpy; if the bank
        # is too sharp to factor (never for this windowed-sinc family),
        # fall back to the stencil path below.
        H, resid = _bank_lowrank(ntaps, cutoff)
        if resid < 1e-3:
            plan = _lowrank_plan(rate, out_len, ntaps, cutoff, H)
            return _lowrank_apply(x, [plan], H, ntaps, out_len,
                                  compute_dtype=compute_dtype)
    if len(runs) + 1 <= 32:
        # stencil fallback (unfittable bank only): per run, d is constant
        # -> every tap v reads a STATIC slice x[a+dv : b+dv] (taps
        # transposed so each tap's per-position vector is a contiguous
        # lane-dim row)
        xp = jnp.pad(x, lead + [(half, ntaps + int(abs(d).max()) + 1)])
        taps_t = jnp.asarray(np.ascontiguousarray(taps_np.T))  # [ntaps, L]
        bounds = [0, *runs.tolist(), out_len]
        segs = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            dv = int(d[a])
            y = jnp.zeros(x.shape[:-1] + (b - a,), dtype=x.dtype)
            for v in range(ntaps):
                y = y + xp[..., a + dv + v : b + dv + v] * taps_t[v, a:b]
            segs.append(y)
        return segs[0] if len(segs) == 1 else jnp.concatenate(segs, axis=-1)

    xp = jnp.pad(x, lead + [(half, ntaps + int(abs(d).max()) + 1)])
    idx = jnp.asarray(base[:, None] + np.arange(ntaps)[None, :])
    windows = xp[..., idx]  # [..., out_len, ntaps]
    return jnp.sum(windows * jnp.asarray(taps_np), axis=-1)


def arbitrary_groups(x: jax.Array, rates, out_len: int,
                     ntaps: int = 33, compute_dtype=None,
                     rank: int = 5) -> jax.Array:
    """Per-channel-group arbitrary resampling sharing ONE filter pass.

    ``x`` is ``[G*g, ..., T]`` — ``len(rates)`` equal contiguous groups
    along axis 0; group ``i`` is resampled by ``rates[i]`` (the BASELINE
    config-3 shape: 64 channels split into ppm clock-offset groups). For
    near-unity rates the low-rank Farrow conv ``z_k = H[k] * x`` is
    rate-INDEPENDENT (the SVD basis depends only on the anti-alias
    cutoff), so one batched conv over all channels replaces G small-batch
    convs; only the cheap
    per-group static-weight combine differs. Falls back to per-group
    :func:`arbitrary` calls outside the shared-kernel regime (any rate
    >1e-3 from unity, sharp bank, or too many integer-shift runs)."""
    G = len(rates)
    if x.shape[0] % G:
        raise ValueError(f"batch {x.shape[0]} not divisible into {G} groups")

    def _fallback():
        g = x.shape[0] // G
        parts = [arbitrary(x[i * g : (i + 1) * g], float(r), out_len,
                           ntaps=ntaps) for i, r in enumerate(rates)]
        return jnp.concatenate(parts, axis=0)

    if any(abs(float(r) - 1.0) > 1e-3 for r in rates):
        return _fallback()
    # Most conservative anti-alias across the groups; at ppm rates the
    # per-rate cutoffs differ by O(ppm) — far below the bank's own
    # stop-band floor.
    cutoff = 0.5 * min(1.0, min(float(r) for r in rates))
    H, resid = _bank_lowrank(ntaps, cutoff, rank)
    # rank 5 holds the 1e-3 (-60 dB) gate; rank 4 lands at ~1.5e-3
    # (-56 dB max) for one fewer HBM plane — still far below the bf16
    # storage floor, so accept it when explicitly requested
    if resid >= (2e-3 if rank == 4 else 1e-3):
        return _fallback()
    plans = [_lowrank_plan(float(r), out_len, ntaps, cutoff, H)
             for r in rates]
    if any(len(p[2]) - 1 > 256 for p in plans):
        return _fallback()
    return _lowrank_apply(x, plans, H, ntaps, out_len,
                          compute_dtype=compute_dtype)
