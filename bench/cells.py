"""The bench cells: stream synthesis, block timing and the per-config
measurements that bench.py, chip_smoke.py and bench/kernel_ab.py share.

Every cell asserts that it decodes the expected frames bit-exactly before
it is timed. Streams are synthesized on the device inside jit; only
integer counts return to the host.
"""

import time

BATCH = 64  # channels
BLOCK = 1 << 16  # samples per channel per step
ITERS = 20  # blocks per timing pass


def block_stream(jax, jnp, cfg, snr_db, tail_margin=0, batch=BATCH, block=BLOCK):
    """A [batch, block] stream of ``cfg`` frames in AWGN at ``snr_db``:
    returns (synthesize(key) -> (x, payloads), expected frame count,
    max_frames). ``tail_margin`` keeps the last frame that far clear of
    the block edge."""
    from liquiddsp_tpu.phy import framegen

    f = framegen.frame_length(cfg)
    gap = int(0.8 * f)
    period = 37 + f + gap  # [lead-in | frame | gap] tile
    starts = [
        37 + i * period for i in range(block // period + 1)
        if 37 + i * period + f <= block - tail_margin
    ]
    max_frames = block // period + 2

    def synthesize(key):
        """On-device stream build: frames + AWGN, no host transfers.

        Frame train built by tiling [frame | gap] — a 2-op layout (an
        unrolled per-start dynamic_update_slice loop bloats XLA compile).
        """
        kp, kn = jax.random.split(key)
        payloads = jax.random.randint(
            kp, (batch, cfg.payload_len), 0, 256, dtype=jnp.int32
        ).astype(jnp.uint8)
        frames = framegen.framegen(payloads, cfg)  # [batch, f]
        pattern = jnp.concatenate(
            [jnp.zeros((batch, starts[0]), jnp.complex64), frames,
             jnp.zeros((batch, gap), jnp.complex64)],
            axis=1,
        )
        reps = -(-block // pattern.shape[1])
        x = jnp.tile(pattern, (1, reps))[:, :block]
        p_sig = jnp.mean(jnp.abs(frames) ** 2)
        sigma = jnp.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        noise = sigma * (
            jax.random.normal(kn, (batch, block))
            + 1j * jax.random.normal(jax.random.fold_in(kn, 1), (batch, block))
        )
        return (x + noise).astype(jnp.complex64), payloads

    return jax.jit(synthesize), len(starts) * batch, max_frames


def time_blocks(jax, fn, x, iters=ITERS, passes=3):
    """Best seconds per call of ``fn(x)`` over ``passes`` timed passes of
    ``iters`` back-to-back calls each, after one warm-up call. The result
    is awaited with block_until_ready at the end of each pass."""
    jax.block_until_ready(fn(x))
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(x)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_config(jax, jnp, cfg, snr_db, require_all=True, transform=None,
                 tail_margin=0):
    """Time framesync_fixed over a BATCH x BLOCK stream of ``cfg`` frames at
    ``snr_db``; returns the per-config result dict. Asserts bit-exactness of
    every decoded payload against its channel's TX payload.

    ``transform``: optional on-device per-block preprocessing INSIDE the
    timed region (e.g. per-channel polyphase resampling, BASELINE config 3);
    ``tail_margin`` keeps the last frame clear of the block edge when the
    transform can consume a few tail samples (rate != 1 resampling)."""
    from liquiddsp_tpu.phy.framesync import framesync_fixed

    synthesize, expected, max_frames = block_stream(
        jax, jnp, cfg, snr_db, tail_margin
    )

    @jax.jit
    def pipeline(key):
        x, payloads = synthesize(key)
        if transform is not None:
            x = transform(x)
        res = framesync_fixed(x, cfg, max_frames=max_frames)
        n_ok = jnp.sum(res.payload_valid.astype(jnp.int32))
        # bit-exactness: every valid slot's payload matches its channel's TX
        match = jnp.all(
            res.payload == payloads[:, None, :], axis=-1
        ) & res.payload_valid
        n_exact = jnp.sum(match.astype(jnp.int32))
        return n_ok, n_exact

    @jax.jit
    def rx_only(x):
        xi = transform(x) if transform is not None else x
        res = framesync_fixed(xi, cfg, max_frames=max_frames)
        return jnp.sum(res.payload_valid.astype(jnp.int32))

    key = jax.random.PRNGKey(0)
    n_ok, n_exact = pipeline(key)
    n_ok = int(n_ok)
    assert n_ok > 0, "bench stream produced no decoded frames"
    assert int(n_exact) == n_ok, "decoded payloads not bit-exact"
    if require_all:
        assert n_ok == expected, f"decoded {n_ok}/{expected} frames"
    else:
        # margin-reduced expectation is a lower bound (edge frames may be
        # consumed by a rate != 1 transform)
        assert n_ok >= expected, f"decoded {n_ok} < {expected} frames"

    # time the RX alone on a fixed on-device stream; best of 3 passes is
    # the rate a warm pipeline sustains
    x, _ = synthesize(key)
    dt = time_blocks(jax, rx_only, x)
    rate = BATCH * BLOCK / dt
    return {
        "config": {
            "modulation": cfg.modulation,
            "inner_code": cfg.inner_code,
            "outer_code": cfg.outer_code,
            "payload_len": cfg.payload_len,
        },
        "snr_db": snr_db,
        "samples_per_sec": rate,
        "ms_per_block": dt * 1e3,
        "frames_per_sec": n_ok / dt,
        "decoded_frames_per_block": n_ok,
        "expected_frames_per_block": expected,
    }


def bench_resampled(jax, jnp, cfg, snr_db):
    """BASELINE config 3: 64 channels with per-channel polyphase
    resampling ahead of detection+decode, all inside the timed jit. Four
    static ppm groups sharing one Farrow conv pass
    (resample.arbitrary_groups; 4x16 channels costs the same FLOPs as 64
    distinct rates)."""
    from liquiddsp_tpu.ops import resample

    ppms = (-50.0, -20.0, 20.0, 50.0)

    def per_channel_resample(x):
        rates = tuple(1.0 + p * 1e-6 for p in ppms)
        # bf16 conv planes + rank 4: ~-50 dB RMS quantization floor,
        # invisible at the bench's 20 dB SNR (payloads still assert
        # bit-exact)
        return resample.arbitrary_groups(
            x, rates, BLOCK, compute_dtype=jnp.bfloat16, rank=4
        ).astype(jnp.complex64)

    return bench_config(
        jax, jnp, cfg, snr_db, require_all=False,
        transform=per_channel_resample, tail_margin=64,
    )


def bench_streaming(jax, jnp, cfg, snr_db, n_chunks=10, chunk_len=1 << 16):
    """Steady-state streaming RX: StreamingRx.step over ``n_chunks`` carried
    chunks (overlap-save boundary handling, runtime/stream.py) — the
    continuous-operation shape of BASELINE config 5 (ref chunk contract at
    lib/flex_rx_impl.h:47). The whole stream stays on device; frames are
    placed so every chunk boundary is straddled by one frame, and the count
    must come out exact (each straddler decoded exactly once, in the next
    chunk's window)."""
    from liquiddsp_tpu.phy import framegen
    from liquiddsp_tpu.runtime.stream import StreamingRx

    f = framegen.frame_length(cfg)
    period = 37 + f + int(0.8 * f)
    total = n_chunks * chunk_len
    synthesize, expected, _ = block_stream(jax, jnp, cfg, snr_db, block=total)
    x, _ = synthesize(jax.random.PRNGKey(1))
    chunks = [x[:, i * chunk_len : (i + 1) * chunk_len] for i in range(n_chunks)]

    # Size the candidate slots to the stream's actual frame density, as the
    # block bench does — the StreamingRx default provisions for worst-case
    # back-to-back frames (~2x the slots here), and every per-candidate RX
    # stage scales with K
    max_frames = (chunk_len + f - 1) // period + 2
    rx = StreamingRx(cfg, BATCH, chunk_len, max_frames_per_chunk=max_frames)

    def run_per_chunk():
        rx.reset()
        acc = None
        for c in chunks:
            res = rx.step(c)
            v = jnp.sum(res.payload_valid.astype(jnp.int32))
            acc = v if acc is None else acc + v
        return int(acc)

    # super-step path: all n_chunks in ONE device dispatch (lax.scan carries
    # the overlap in-graph, runtime/stream.py superstep), with the
    # exactly-once straddle contract of the per-chunk path (pinned in
    # tests/test_runtime.py TestSuperstep)
    stacked = jnp.stack(chunks, axis=1)  # [B, N, L]
    count = jax.jit(lambda r: jnp.sum(r.payload_valid.astype(jnp.int32)))

    def run_scanned():
        rx.reset()
        return int(count(rx.superstep(stacked)))

    n_ok_chunk = run_per_chunk()  # compile + correctness
    assert n_ok_chunk == expected, f"per-chunk decoded {n_ok_chunk}/{expected}"
    n_ok = run_scanned()
    assert n_ok == expected, f"scanned decoded {n_ok}/{expected} frames"

    # steady-state timing: REPS super-blocks per pass with the counts
    # accumulated on the device and one fetch at the end of the pass
    reps = 5

    def run_scanned_reps():
        acc = None
        for _ in range(reps):
            rx.reset()
            v = count(rx.superstep(stacked))
            acc = v if acc is None else acc + v
        return int(acc)

    def run_per_chunk_reps():
        acc = None
        for _ in range(reps):
            rx.reset()
            for c in chunks:
                res = rx.step(c)
                v = jnp.sum(res.payload_valid.astype(jnp.int32))
                acc = v if acc is None else acc + v
        return int(acc)

    def best_of_3(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn()
            best = min(best, time.perf_counter() - t0)
            assert got == expected * reps
        return best

    dt_scan = best_of_3(run_scanned_reps)
    dt_chunk = best_of_3(run_per_chunk_reps)
    rate = BATCH * total * reps / dt_scan
    rate_chunk = BATCH * total * reps / dt_chunk

    # occupancy-adaptive decode (runtime/stream.py run_adaptive): DEFAULT
    # worst-case construction — no manual max_frames_per_chunk footgun —
    # with the slot count following the measured detector demand. The
    # per-call costs (one batched demand fetch + one count fetch) amortize
    # over the call length, so the adaptive path is measured on a longer
    # tiled stream — the steady-state shape of continuous operation, where
    # adaptation cadence is one call.
    rx_ad = StreamingRx(cfg, BATCH, chunk_len)
    ad_tile = 3
    x_long = jnp.tile(x, (1, ad_tile))
    # each tile copy restarts the frame pattern at phase 0, so any frame
    # cut at a copy's end stays partial (CRC-fails) and no new frames
    # appear at the seams: expected is exactly per-copy count x tiles
    expected_ad = expected * ad_tile

    def run_adaptive_pass():
        rx_ad.reset()
        # split=False: one stacked result per launch group, reduced on
        # the device
        results = rx_ad.run_adaptive(x_long, chunks_per_launch=5, split=False)
        tot = None
        for r in results:
            v = jnp.sum(r.payload_valid.astype(jnp.int32))
            tot = v if tot is None else tot + v
        return int(tot)

    got_ad = run_adaptive_pass()  # compile + correctness (+bucket climb)
    assert got_ad == expected_ad, f"adaptive decoded {got_ad}/{expected_ad}"
    best_ad = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        got = run_adaptive_pass()
        best_ad = min(best_ad, time.perf_counter() - t0)
        assert got == expected_ad
    rate_ad = BATCH * total * ad_tile / best_ad

    return {
        "samples_per_sec": rate,
        "chunk_len": chunk_len,
        "n_chunks": n_chunks,
        "chunks_per_launch": n_chunks,
        "super_blocks_per_pass": reps,
        "per_chunk_dispatch_samples_per_sec": rate_chunk,
        "adaptive_samples_per_sec": rate_ad,
        "adaptive_buckets_compiled": sorted(rx_ad._adaptive_progs),
        "decoded_frames": n_ok,
        "expected_frames": expected,
    }
