"""GPU kernel parity tests (Pallas interpret mode on the CPU vs the plain
paths), symbol recovery against a numpy reference, and the platform check
that picks each kernel. Tests marked ``gpu`` run the compiled kernels on
the card and skip elsewhere."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liquiddsp_tpu.kernels import choose, correlator
from liquiddsp_tpu.kernels.correlator import BF16_RTOL
from liquiddsp_tpu.phy import detector


def _corr_case(seed):
    tmpl = detector.templates_time()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 3000)) + 1j * rng.standard_normal((2, 3000))).astype(
        np.complex64
    )
    x[0, 500:628] += 5 * detector.template()
    x[1, 1700:1828] += 3 * np.asarray(tmpl[3])  # frequency-shifted hit
    return jnp.asarray(x), tmpl


class TestCorrelatorKernel:
    def test_interpret_matches_xla(self):
        """The kernel equals the plain block-Toeplitz matmuls with the same
        bf16 operands (only the f32 summation order differs)."""
        x, tmpl = _corr_case(0)
        a = correlator.correlate_reduced_mm(x, tmpl, dtype=jnp.bfloat16)
        b = correlator.correlate_reduced(x, tmpl, backend="triton_interpret")
        np.testing.assert_allclose(np.asarray(a["rho2"]), np.asarray(b["rho2"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(a["energy"]), np.asarray(b["energy"]),
                                   rtol=1e-5, atol=1e-3)
        peaks = np.asarray(a["rho2"]) > 0.04
        assert peaks.any()
        np.testing.assert_array_equal(
            np.asarray(a["fbin"])[peaks], np.asarray(b["fbin"])[peaks]
        )
        np.testing.assert_allclose(
            np.asarray(a["corr"])[peaks], np.asarray(b["corr"])[peaks], rtol=1e-4, atol=1e-3
        )

    def test_bf16_matches_f32_to_operating_precision(self):
        """The kernel's bf16 operands (f32 accumulation) keep rho2/corr
        within BF16_RTOL of the f32 paths — far below the 10-20 dB operating
        SNR of the detector."""
        x, tmpl = _corr_case(2)
        a = correlator.correlate_reduced(x, tmpl, backend="mm")
        f = correlator.correlate_reduced(x, tmpl, backend="fft")
        b = correlator.correlate_reduced(x, tmpl, backend="triton_interpret")
        scale = float(np.max(np.asarray(a["rho2"])))
        for ref in (a, f):
            np.testing.assert_allclose(
                np.asarray(ref["rho2"]), np.asarray(b["rho2"]), atol=BF16_RTOL * scale
            )
        np.testing.assert_allclose(
            np.asarray(a["energy"]), np.asarray(b["energy"]), rtol=BF16_RTOL, atol=1e-2
        )
        # at genuine peaks the reduced quantities must agree closely
        peaks = np.asarray(a["rho2"]) > 0.5
        assert peaks.any()
        np.testing.assert_array_equal(
            np.asarray(a["fbin"])[peaks], np.asarray(b["fbin"])[peaks]
        )
        np.testing.assert_allclose(
            np.asarray(a["corr"])[peaks], np.asarray(b["corr"])[peaks], rtol=BF16_RTOL
        )

    def _frame_stream(self, seed, noise):
        from liquiddsp_tpu.core.config import FrameConfig
        from liquiddsp_tpu.phy import framegen

        cfg = FrameConfig(modulation=1, inner_code=0, outer_code=0, payload_len=64)
        rng = np.random.default_rng(seed)
        payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
        frame = np.asarray(framegen.framegen(jnp.asarray(payload), cfg))
        x = np.zeros((1, 4096), dtype=np.complex64)
        x[0, 777 : 777 + frame.shape[1]] = frame
        x += (noise * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
              ).astype(np.complex64)
        return jnp.asarray(x)

    def test_detect_same_results_via_pallas_interpret_bf16(self):
        """End-to-end detect() with the bf16 kernel: identical mask/start to
        the FFT path on a noisy frame (detection decisions are threshold
        compares ~3 orders of magnitude above bf16 rounding)."""
        x = self._frame_stream(7, 0.05)
        d_ref = detector.detect(x, max_frames=2, backend="fft")
        d_pal = detector.detect(x, max_frames=2, backend="triton_interpret")
        np.testing.assert_array_equal(np.asarray(d_ref.mask), np.asarray(d_pal.mask))
        np.testing.assert_array_equal(np.asarray(d_ref.start), np.asarray(d_pal.start))
        np.testing.assert_allclose(
            np.asarray(d_ref.gamma), np.asarray(d_pal.gamma), rtol=1e-2
        )
        np.testing.assert_allclose(
            np.asarray(d_ref.tau), np.asarray(d_pal.tau), atol=0.06
        )

    def test_detect_same_results_via_pallas_interpret(self):
        x = self._frame_stream(1, 0.0)
        d_ref = detector.detect(x, max_frames=2, backend="mm")
        d_pal = detector.detect(x, max_frames=2, backend="triton_interpret")
        np.testing.assert_array_equal(np.asarray(d_ref.mask), np.asarray(d_pal.mask))
        np.testing.assert_array_equal(np.asarray(d_ref.start), np.asarray(d_pal.start))
        np.testing.assert_allclose(
            np.asarray(d_ref.gamma), np.asarray(d_pal.gamma), rtol=BF16_RTOL
        )

    def test_padding_to_whole_programs(self):
        """Streams that are not a multiple of the kernel's tile come back at
        their own length, and the lags next to the end agree too."""
        from liquiddsp_tpu.kernels.correlator import LT, NBT

        tmpl = detector.templates_time()
        t = NBT * tmpl.shape[1] + 77  # spills into a second row of programs
        rng = np.random.default_rng(4)
        x = jnp.asarray((rng.standard_normal((1, t)) + 1j * rng.standard_normal((1, t))
                         ).astype(np.complex64))
        got = correlator.correlate_reduced(x, tmpl, backend="triton_interpret")
        ref = correlator.correlate_reduced_mm(x, tmpl, dtype=jnp.bfloat16)
        assert tmpl.shape[1] % LT == 0
        for k in ("rho2", "fbin", "corr", "energy"):
            assert got[k].shape == (1, t), k
        np.testing.assert_allclose(np.asarray(got["energy"]), np.asarray(ref["energy"]),
                                   rtol=1e-5, atol=1e-3)


def _numpy_symbols(win, det, n_syms, taps30):
    """Derotate by exp(-j(dphi n + phi)) / gamma, then the 30-tap matched
    filter decimated by 2: y[s] = sum_v w[2s + v] taps30[v]."""
    win = np.asarray(win, np.complex128)
    n = np.arange(win.shape[-1])
    rot = np.exp(-1j * (np.asarray(det.dphi)[..., None] * n
                        + np.asarray(det.phi)[..., None]))
    w = win * rot / np.asarray(det.gamma)[..., None]
    taps = np.asarray(taps30, np.float64)
    y = np.zeros(win.shape[:-1] + (n_syms,), np.complex128)
    for v in range(taps.shape[-1]):
        y += w[..., v : v + 2 * n_syms : 2] * taps[..., v, None]
    return y


class TestSymbolRecovery:
    @pytest.mark.parametrize("timing_bank", [True, False], ids=["bank", "no_bank"])
    def test_matches_numpy_reference(self, timing_bank):
        """symbols_from_windows (window derotation + polyphase matched
        filter, the plain path that replaced the fused recovery kernel)
        against a direct numpy derotate + filter + decimate."""
        from liquiddsp_tpu.phy import frame_spec as fs
        from liquiddsp_tpu.phy.detector import Detections
        from liquiddsp_tpu.phy.framesync import _candidate_taps30, symbols_from_windows

        b, k, n_syms = 2, 3, 200
        rng = np.random.default_rng(0)
        n_samples = fs.K_SAMP * n_syms + fs.PULSE_TAIL
        win = (rng.standard_normal((b, k, n_samples))
               + 1j * rng.standard_normal((b, k, n_samples))).astype(np.complex64)
        det = Detections(
            mask=jnp.ones((b, k), bool),
            start=jnp.zeros((b, k), jnp.int32),
            rho=jnp.ones((b, k), jnp.float32),
            gamma=jnp.asarray(rng.uniform(0.5, 2.0, (b, k)), jnp.float32),
            dphi=jnp.asarray(rng.uniform(-0.05, 0.05, (b, k)), jnp.float32),
            phi=jnp.asarray(rng.uniform(-np.pi, np.pi, (b, k)), jnp.float32),
            tau=jnp.asarray(rng.uniform(-0.5, 0.5, (b, k)), jnp.float32),
        )
        got = np.asarray(symbols_from_windows(jnp.asarray(win), det, n_syms, timing_bank))
        taps = _candidate_taps30(det, timing_bank)
        ref = _numpy_symbols(win, det, n_syms, taps)
        assert got.shape == (b, k, n_syms)
        np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max())


class TestExtractWindows:
    def test_edge_start_reads_zero_pad(self):
        x = jnp.ones((1, 200), jnp.complex64)
        starts = jnp.asarray([[150]], jnp.int32)
        w = np.asarray(detector.extract_windows(x, starts, 128))
        assert w[0, 0, :50].real.all() and not w[0, 0, 50:].any()


class TestPlatformChoice:
    @pytest.mark.parametrize(
        "platform,backend,want",
        [("gpu", None, "kernel"), ("cpu", None, "plain"), ("gpu", "plain", "plain"),
         ("cpu", "kernel", "kernel")],
    )
    def test_choose(self, monkeypatch, platform, backend, want):
        """The kernel on a GPU, the plain path elsewhere; an explicit
        backend wins on either."""
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert choose(backend, "kernel", "plain") == want

    def test_library_calls_pick_kernels_on_gpu(self, monkeypatch):
        """With no backend given, the correlator and the Viterbi decode
        reach their Triton kernels on a GPU and their plain paths on the
        CPU."""
        from liquiddsp_tpu.kernels import viterbi
        from liquiddsp_tpu.ops.fec import conv

        calls = []
        monkeypatch.setattr(correlator, "correlate_reduced_triton",
                            lambda x, t: calls.append("corr") or "k")
        monkeypatch.setattr(correlator, "correlate_reduced_mm",
                            lambda x, t: calls.append("corr_mm") or "p")
        monkeypatch.setattr(viterbi, "viterbi_triton",
                            lambda lam, *a, **k: calls.append("vit") or jnp.zeros(
                                lam.shape[:2], jnp.int8))
        llr = jnp.ones((1, conv.num_coded_bits(8, 1)))
        for platform in ("gpu", "cpu"):
            monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
            correlator.correlate_reduced(None, None)
            conv.decode(llr, 8, 1)
        assert calls == ["corr", "vit", "corr_mm"]


@pytest.mark.gpu
class TestKernelsOnCard:
    def test_correlator_compiled(self, gpu):
        x, tmpl = _corr_case(5)
        got = jax.jit(functools.partial(correlator.correlate_reduced_triton,
                                        templates=tmpl))(x)
        ref = correlator.correlate_reduced_mm(x, tmpl, dtype=jnp.bfloat16)
        np.testing.assert_allclose(np.asarray(got["rho2"]), np.asarray(ref["rho2"]),
                                   rtol=1e-3, atol=1e-5)

    def test_viterbi_compiled(self, gpu):
        from liquiddsp_tpu.ops.fec import conv

        rng = np.random.default_rng(9)
        bits = rng.integers(0, 2, (37, 500)).astype(np.int8)
        llr = 1.0 - 2.0 * np.stack([conv.encode_host(b, 2) for b in bits])
        llr = jnp.asarray(llr + rng.standard_normal(llr.shape), jnp.float32)
        got = conv.decode(llr, 500, 2, backend="triton")
        ref = conv.decode(llr, 500, 2, backend="xla")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
