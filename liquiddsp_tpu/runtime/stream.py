"""Chunked streaming RX with carry state across block boundaries.

The reference streams continuously: GR hands flex_rx 256-sample chunks and
liquid's flexframesync keeps internal history so a frame may straddle any
chunk boundary (lib/flex_rx_impl.h:47, cc:210-215; SURVEY.md section 5.7).

Here the chunk is a large batched block and the carry state is an
explicit overlap buffer (overlap-save): each step processes
``window = [carry | chunk]`` where ``len(carry) = max_frame_samples - 1``,
and only frames *fully contained* in the window (start <= W - F) are
decoded. A frame starting in the last F-1 samples reappears at the head of
the next window and is decoded exactly once there — the same contract that
becomes ppermute halo exchange when time is sharded across chips
(parallel/halo.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from liquiddsp_tpu.core.config import FrameConfig
from liquiddsp_tpu.phy import frame_spec as fs
from liquiddsp_tpu.phy.framesync import FrameResults, framesync_fixed


# slot-count buckets for the occupancy-adaptive decode: geometric-ish so
# the compile count stays small while overshoot stays ~<=25%
K_BUCKETS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 40, 48, 64)


class StreamingRx:
    """Stateful streaming wrapper around the block framesync.

    One instance per continuous stream batch [B, *]. ``chunk_len`` is static;
    every step jit-executes one compiled program.

    Performance note: every per-candidate RX stage scales with the K
    candidate slots, and the ``max_frames_per_chunk`` default provisions
    for worst-case back-to-back frames. When the deployment's maximum frame
    rate is known, pass ``max_frames_per_chunk`` sized to it, or use
    :meth:`run_adaptive`, which sizes K from the measured demand.
    """

    def __init__(
        self,
        cfg: FrameConfig,
        batch: int,
        chunk_len: int,
        max_frames_per_chunk: int | None = None,
        threshold: float = 0.45,
    ):
        self.cfg = cfg
        self.batch = batch
        self.chunk_len = chunk_len
        spec = fs.FrameSpec(cfg)
        self.frame_samples = spec.frame_samples
        self.overlap = self.frame_samples - 1
        if chunk_len <= self.overlap:
            raise ValueError(
                f"chunk_len {chunk_len} must exceed overlap {self.overlap}"
            )
        self.max_frames = max_frames_per_chunk or max(
            2, (chunk_len + self.overlap) // self.frame_samples + 1
        )
        self.threshold = threshold
        self._carry = self._make_carry()
        self._samples_consumed = 0  # absolute index of carry[0] (python int)
        self.start_epoch = 0  # host-side 2^30 base of res.start (see _base)
        self._pending = None  # push() arrival buffer (host, [B, <chunk_len])
        self._step = jax.jit(
            functools.partial(
                _stream_step,
                cfg=cfg,
                max_frames=self.max_frames,
                threshold=threshold,
                frame_samples=self.frame_samples,
            )
        )
        self._superstep = jax.jit(
            functools.partial(
                _stream_superstep,
                cfg=cfg,
                max_frames=self.max_frames,
                threshold=threshold,
                frame_samples=self.frame_samples,
                chunk_len=chunk_len,
            )
        )

    def _make_carry(self) -> jax.Array:
        return jnp.zeros((self.batch, self.overlap), dtype=jnp.complex64)

    def reset(self) -> None:
        """Zero the carry and stream position (a new stream on the same
        compiled step — reuses the jit cache, unlike a fresh instance)."""
        self._carry = self._make_carry()
        self._samples_consumed = 0
        self.start_epoch = 0
        self._pending = None

    def _base(self) -> jax.Array:
        """In-epoch window base as a device int32.

        ``start`` rides on-device as int32, which would silently wrap after
        2^31 stream samples (~36 min of a 1 Msamp/s channel) — fatal for
        consumers deduping on absolute indices (runtime/supervisor.py
        checkpoint contract). The unbounded python-int position is split
        into ``start_epoch`` (an exact multiple of 2^30, host side) plus a
        small in-epoch offset (device side): absolute index =
        ``rx.start_epoch + res.start``. Streams shorter than 2^30 samples
        always see epoch 0, i.e. ``res.start`` absolute as before. Read
        ``start_epoch`` before the next step — it advances with the
        stream."""
        base_abs = self._samples_consumed - self.overlap
        self.start_epoch = (max(base_abs, 0) >> 30) << 30
        return jnp.int32(base_abs - self.start_epoch)

    def step(self, chunk: jax.Array) -> FrameResults:
        """Process [B, chunk_len] new samples; returns FrameResults whose
        ``start`` fields are stream sample indices relative to
        ``self.start_epoch`` (zero for streams under 2^30 samples — see
        :meth:`_base`)."""
        assert chunk.shape == (self.batch, self.chunk_len)
        # window[0] sits at absolute index samples_consumed - overlap; the
        # offset rides into the jitted step as a traced scalar (one compiled
        # program, one dispatch per chunk — a host-side replace() after the
        # step cost a second dispatch per chunk)
        res, self._carry = self._step(self._carry, chunk, self._base())
        self._samples_consumed += self.chunk_len
        # stamp the epoch this step ran under on the result itself (host-side
        # static field) so multi-step calls (push/run) return results that
        # are individually absolute-index safe: abs = res.epoch + res.start.
        # self.start_epoch only reflects the LAST step of such a call.
        return dataclasses.replace(res, epoch=self.start_epoch)

    def push(self, samples: np.ndarray | jax.Array) -> list[FrameResults]:
        """GR-style arbitrary chunking (the reference contract feeds
        flexframesync 256-sample chunks, lib/flex_rx_impl.cc:213): accept
        [B, n] for ANY n >= 1, buffer host-side, and run the compiled
        fixed-size step whenever a full ``chunk_len`` has accumulated.
        Returns the FrameResults of every step completed by this push
        (possibly empty — no device work happens until a step is full).
        Each result carries the epoch of ITS step in ``res.epoch``
        (absolute index = ``res.epoch + res.start``) — do not use
        ``self.start_epoch`` for multi-result calls, it only reflects the
        last step.

        The accumulator is NOT the overlap carry: it only quantizes arrival
        sizes up to the compiled step size; boundary-straddle semantics are
        unchanged. Use :meth:`flush` at end-of-stream to drain the tail."""
        samples = np.asarray(samples)
        assert samples.ndim == 2 and samples.shape[0] == self.batch
        if self._pending is None:
            self._pending = np.zeros((self.batch, 0), dtype=np.complex64)
        self._pending = np.concatenate(
            [self._pending, samples.astype(np.complex64)], axis=1
        )
        out: list[FrameResults] = []
        while self._pending.shape[1] >= self.chunk_len:
            chunk = self._pending[:, : self.chunk_len]
            self._pending = self._pending[:, self.chunk_len :]
            out.append(self.step(jnp.asarray(chunk)))
        return out

    def flush(self) -> FrameResults | None:
        """End-of-stream: zero-pad the pending tail to one chunk and step.
        Returns None when nothing is pending. Frames that would extend past
        the true end of data decode against zeros (as in :meth:`run`'s tail
        padding)."""
        if self._pending is None or self._pending.shape[1] == 0:
            return None
        pad = self.chunk_len - self._pending.shape[1]
        chunk = np.pad(self._pending, ((0, 0), (0, pad)))
        self._pending = np.zeros((self.batch, 0), dtype=np.complex64)
        return self.step(jnp.asarray(chunk))

    def superstep(self, chunks: jax.Array) -> FrameResults:
        """Process N chunks in ONE device dispatch.

        The per-chunk overlap carry becomes a ``lax.scan`` carry so the whole
        multi-chunk window sweep compiles to a single program — one launch
        for N chunks instead of one per chunk. Semantics are identical to N sequential :meth:`step`
        calls, including the exactly-once straddle contract (a frame starting
        in the last F-1 samples of chunk i is decoded in chunk i+1's window).

        Args:
          chunks: ``[B, N, chunk_len]`` (or ``[B, N*chunk_len]``, reshaped).

        Returns:
          FrameResults stacked on a leading chunk axis — every field is
          ``[N, B, K, ...]``; ``start`` is relative to ``res.epoch`` (==
          ``self.start_epoch`` at launch time; one epoch covers the whole
          launch): absolute index = ``res.epoch + start``.
        """
        if chunks.ndim == 2:
            b, t = chunks.shape
            assert t % self.chunk_len == 0, (t, self.chunk_len)
            chunks = chunks.reshape(b, t // self.chunk_len, self.chunk_len)
        assert chunks.shape[0] == self.batch and chunks.shape[2] == self.chunk_len
        n = chunks.shape[1]
        # base0 can sit up to 2^30 into the current epoch; bound the largest
        # in-launch index (base0 + n*chunk_len + window) below int32 max
        assert n * self.chunk_len + self.frame_samples < (1 << 30), (
            "launch exceeds one start epoch"
        )
        res, self._carry = self._superstep(self._carry, chunks, self._base())
        self._samples_consumed += n * self.chunk_len
        return dataclasses.replace(res, epoch=self.start_epoch)

    def _adaptive_prog(self, k: int):
        """Cached jitted counted-superstep at slot count ``k`` (compiled
        lazily — a steady stream only ever compiles its own bucket)."""
        progs = getattr(self, "_adaptive_progs", None)
        if progs is None:
            progs = self._adaptive_progs = {}
        if k not in progs:
            step = functools.partial(
                _stream_superstep,
                cfg=self.cfg,
                max_frames=k,
                threshold=self.threshold,
                frame_samples=self.frame_samples,
                chunk_len=self.chunk_len,
                with_count=True,
            )

            # the group's demand reduces to ONE device scalar inside the
            # program — the host fetch then awaits a ready buffer instead
            # of dispatching a fresh reduction at resolve time
            def prog(carry, chunks, base, _step=step):
                (res, counts), new_carry = _step(carry, chunks, base)
                return (res, jnp.max(counts)), new_carry

            progs[k] = jax.jit(prog)
        return progs[k]

    def _run_group(self, stacked: jax.Array, k: int):
        """One adaptive launch group: N chunks, slot count k. Returns
        (stacked FrameResults [N, B, k, ...], demand counts [N, B])."""
        n = stacked.shape[1]
        assert n * self.chunk_len + self.frame_samples < (1 << 30)
        (res, demand), self._carry = self._adaptive_prog(k)(
            self._carry, stacked, self._base()
        )
        self._samples_consumed += n * self.chunk_len
        return dataclasses.replace(res, epoch=self.start_epoch), demand

    def run_adaptive(
        self,
        stream: np.ndarray | jax.Array,
        chunks_per_launch: int = 5,
        k_buckets: tuple[int, ...] = K_BUCKETS,
        headroom: int = 2,
        split: bool = True,
    ) -> list[FrameResults]:
        """Occupancy-adaptive :meth:`run`: the decode slot count K follows
        the MEASURED detector demand instead of worst-case provisioning.

        Every per-candidate RX stage scales with K, and the default
        worst-case K (back-to-back frames) costs ~2x the work on
        realistic frame densities — but a manual
        ``max_frames_per_chunk`` is a footgun (a burst above it silently
        drops frames). Here each launch group (``chunks_per_launch``
        chunks, one dispatch) also returns the per-window threshold-peak
        COUNTS (phy/detector.py return_count — the demand before the
        top-K cut), reduced to one device scalar per group. ALL groups of
        a call dispatch back-to-back at the current bucket; their demand
        scalars are then stacked and fetched in ONE transfer (one blocking
        fetch per call instead of one per group), any group whose demand exceeded
        its K is re-decoded at a covering bucket, and the settled bucket
        persists on the instance for the next call. Exactly-once is
        unaffected: the overlap carry is raw data, independent of K, so a
        redo reproduces the same carry chain.

        Worst case (burst in every group) this degenerates to ~2x work of
        :meth:`run` at the right K; steady state it does strictly less
        work than worst-case provisioning, with K covering demand plus
        ``headroom`` extra frames so small fluctuations do not trigger
        redos. Adaptation latency is one call — size the stream argument
        to the cadence at which occupancy realistically drifts.
        """
        b, t = stream.shape
        buckets = sorted({k for k in k_buckets if k < self.max_frames})
        buckets.append(self.max_frames)  # demand can never exceed this...
        # ...well, it can (pathological threshold chatter), but max_frames
        # IS the provisioning run() would have used — never decode worse.

        def pick(demand: int) -> int:
            want = demand + headroom
            idx = 0
            while idx < len(buckets) - 1 and buckets[idx] < want:
                idx += 1
            return buckets[idx]

        chunks = []
        for pos in range(0, t, self.chunk_len):
            chunk = stream[:, pos : pos + self.chunk_len]
            if chunk.shape[1] < self.chunk_len:
                chunk = jnp.pad(chunk, ((0, 0), (0, self.chunk_len - chunk.shape[1])))
            chunks.append(jnp.asarray(chunk, jnp.complex64))
        n_full = (len(chunks) // chunks_per_launch) * chunks_per_launch

        # the settled bucket persists across calls (and reset()): a steady
        # stream pays the climb from the smallest bucket exactly once
        k = getattr(self, "_adaptive_k", None) or buckets[0]
        if k not in buckets:
            k = buckets[0]

        # phase 1: dispatch every group at the current bucket, keeping the
        # per-group demand scalars ON DEVICE
        groups = []  # [stacked, state_before, res, demand_dev]
        for g in range(0, n_full, chunks_per_launch):
            group = chunks[g : g + chunks_per_launch]
            stacked = jnp.stack(group, axis=1)
            state_before = (self._carry, self._samples_consumed)
            res, demand_dev = self._run_group(stacked, k)
            groups.append([stacked, state_before, res, demand_dev])

        if groups:
            # phase 2: ONE stacked fetch for every group's demand
            demands = np.asarray(
                jnp.stack([g[3] for g in groups])
            ).astype(np.int64)
            # phase 3: re-decode any overflowed group at a covering bucket
            # (rare; carry chain is K-independent, see docstring)
            for gi, entry in enumerate(groups):
                if demands[gi] > k:
                    k_fix = pick(int(demands[gi]))
                    live = (
                        self._carry, self._samples_consumed, self.start_epoch,
                    )
                    self._carry, self._samples_consumed = entry[1]
                    entry[2], _ = self._run_group(entry[0], k_fix)
                    (
                        self._carry, self._samples_consumed, self.start_epoch,
                    ) = live
            self._adaptive_k = pick(int(demands.max()))

        # ``split=False`` returns one stacked FrameResults ([N, B, K, ...])
        # per launch group: splitting into per-chunk results issues one
        # eager device slice per field per chunk. Device-side consumers
        # should reduce over the stacked results directly.
        out: list[FrameResults] = []
        for stacked, _, res, _ in groups:
            if split:
                out.extend(split_results(res, stacked.shape[1]))
            else:
                out.append(res)
        # short tail rides the already-compiled worst-case per-chunk step
        for c in chunks[n_full:]:
            out.append(self.step(c))
        return out

    def run(
        self, stream: np.ndarray | jax.Array, chunks_per_launch: int = 1
    ) -> list[FrameResults]:
        """Convenience: chop [B, T] into chunks (zero-padding the tail).

        ``chunks_per_launch > 1`` routes groups of chunks through
        :meth:`superstep` (one dispatch per group) and unstacks the result —
        same list-of-per-chunk-FrameResults contract either way."""
        b, t = stream.shape
        chunks = []
        for pos in range(0, t, self.chunk_len):
            chunk = stream[:, pos : pos + self.chunk_len]
            if chunk.shape[1] < self.chunk_len:
                chunk = jnp.pad(chunk, ((0, 0), (0, self.chunk_len - chunk.shape[1])))
            chunks.append(jnp.asarray(chunk, jnp.complex64))
        out: list[FrameResults] = []
        if chunks_per_launch <= 1:
            for c in chunks:
                out.append(self.step(c))
            return out
        n_full = (len(chunks) // chunks_per_launch) * chunks_per_launch
        for g in range(0, n_full, chunks_per_launch):
            group = chunks[g : g + chunks_per_launch]
            stacked = self.superstep(jnp.stack(group, axis=1))
            out.extend(split_results(stacked, len(group)))
        # short tail rides the already-compiled per-chunk step — a scan of a
        # different static length would recompile the whole RX pipeline
        for c in chunks[n_full:]:
            out.append(self.step(c))
        return out


def _stream_step(
    carry, chunk, base, *, cfg, max_frames, threshold, frame_samples,
    with_count: bool = False,
):
    window = jnp.concatenate([carry, chunk], axis=-1)
    out = framesync_fixed(
        window, cfg, max_frames=max_frames, threshold=threshold,
        return_peak_count=with_count,
    )
    res, count = out if with_count else (out, None)
    w = window.shape[-1]
    contained = res.start <= w - frame_samples
    mask = res.mask & contained
    res = dataclasses.replace(
        res,
        mask=mask,
        header_valid=res.header_valid & contained,
        payload_valid=res.payload_valid & contained,
        # start as absolute stream sample index (base = position of carry[0])
        start=res.start + base,
    )
    new_carry = window[:, -(frame_samples - 1):]
    if with_count:
        return (res, count), new_carry
    return res, new_carry


def _stream_superstep(
    carry, chunks, base0, *, cfg, max_frames, threshold, frame_samples,
    chunk_len, with_count: bool = False,
):
    """N chunks per launch: the overlap buffer rides as the scan carry.

    ``chunks`` is [B, N, L]; the scan body is exactly ``_stream_step`` so the
    scanned path and the per-chunk path are the same program by construction
    (tests/test_runtime.py pins equality). XLA compiles the body once and
    loops on-device — one dispatch for the whole group. ``with_count``
    additionally stacks the per-chunk detector demand [N, B] (the
    occupancy-adaptive decode's slot-sizing signal)."""

    def body(c, chunk):
        buf, base = c
        res, new_buf = _stream_step(
            buf, chunk, base, cfg=cfg, max_frames=max_frames,
            threshold=threshold, frame_samples=frame_samples,
            with_count=with_count,
        )
        return (new_buf, base + chunk_len), res

    (new_carry, _), res = jax.lax.scan(
        body, (carry, base0), jnp.swapaxes(chunks, 0, 1)
    )
    return res, new_carry


def split_results(stacked: FrameResults, n: int) -> list[FrameResults]:
    """Unstack a [N, B, K, ...] superstep result into N per-chunk results.

    Pure device-side indexing (lazy slices) — no host transfer."""
    return [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(n)]
