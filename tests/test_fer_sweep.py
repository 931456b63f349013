"""Payload FER-vs-SNR statistical bounds (BASELINE configs 1-2 contract).

Small-N CPU version of bench/fer_sweep.py (which runs the full sweep on
a GPU). Asserts the waterfall shape: FER
monotone non-increasing in SNR (with slack for small N), zero at high SNR,
and a coding gain for the FEC config at low SNR.
"""

import jax
import jax.numpy as jnp
import pytest

from bench.fer_sweep import run_point
from liquiddsp_tpu.core.config import FrameConfig

TRIALS = 16


def fer_at(cfg, snr_db, seed=0):
    det, hdr, ok = run_point(jax, jnp, cfg, snr_db, TRIALS, seed=seed)
    return 1.0 - ok / TRIALS


class TestFERSweep:
    def test_fec_waterfall_monotone_and_floor(self):
        cfg = FrameConfig(1, 1, 1, 64)  # QPSK + V27 + Golay
        fers = [fer_at(cfg, snr, seed=3) for snr in (2.5, 7.5, 15.0)]
        # small-N slack: allow one trial of non-monotonicity
        assert fers[0] + 1.0 / TRIALS >= fers[1] >= fers[2] - 1.0 / TRIALS
        assert fers[2] == 0.0, f"FEC config has FER {fers[2]} at 15 dB"
        assert fers[1] == 0.0, f"FEC config has FER {fers[1]} at 7.5 dB"

    def test_uncoded_clean_at_high_snr(self):
        cfg = FrameConfig(1, 0, 0, 64)  # QPSK uncoded
        assert fer_at(cfg, 20.0, seed=5) == 0.0

    def test_coding_gain_at_low_snr(self):
        snr = 5.0
        coded = fer_at(FrameConfig(1, 1, 1, 64), snr, seed=7)
        uncoded = fer_at(FrameConfig(1, 0, 0, 64), snr, seed=7)
        assert coded <= uncoded, f"no coding gain: coded {coded} vs uncoded {uncoded}"


class TestTheoryAnchor:
    """Waterfall POSITION vs the closed-form AWGN curve:
    the measured uncoded FER at snr must not exceed the theory FER at
    snr - 1 dB, i.e. total implementation loss (detection, CFO/timing
    estimation, carrier tracking, EQ coefficient noise) under 1 dB. A
    silently mistuned RX (e.g. the pre-r3 fine-CFO timing bias, which cost
    ~4% header outage at 10 dB) fails this where shape-only monotonicity
    assertions pass."""

    N = 256

    def _measured(self, cfg, snr, seed):
        det, hdr, ok = run_point(jax, jnp, cfg, snr, self.N, seed=seed)
        return 1.0 - ok / self.N

    def test_qpsk_within_1db_of_theory(self):
        from bench.fer_sweep import theory_uncoded_fer

        snr = 9.5  # theory FER ~1e-2 region
        fer = self._measured(FrameConfig(1, 0, 0, 64), snr, seed=11)
        bound = theory_uncoded_fer(1, 64, snr - 1.0)
        assert fer <= bound, (
            f"QPSK FER {fer:.4f} at {snr} dB exceeds theory({snr - 1.0} dB)="
            f"{bound:.4f}: implementation loss > 1 dB"
        )

    def test_bpsk_within_1db_of_theory(self):
        from bench.fer_sweep import theory_uncoded_fer

        snr = 6.0
        fer = self._measured(FrameConfig(0, 0, 0, 64), snr, seed=13)
        bound = theory_uncoded_fer(0, 64, snr - 1.0)
        assert fer <= bound, (
            f"BPSK FER {fer:.4f} at {snr} dB exceeds theory({snr - 1.0} dB)="
            f"{bound:.4f}: implementation loss > 1 dB"
        )

    def test_qam16_within_1db_of_theory(self):
        """Exact square-QAM SER anchor: catches QAM-only impairments (e.g.
        an LLR/decision scaling bug) that the BPSK/QPSK anchors cannot see."""
        from bench.fer_sweep import theory_uncoded_fer

        snr = 15.5  # theory FER ~3e-2 region
        fer = self._measured(FrameConfig(8, 0, 0, 64), snr, seed=17)
        bound = theory_uncoded_fer(8, 64, snr - 1.0)
        assert fer <= bound, (
            f"QAM16 FER {fer:.4f} at {snr} dB exceeds theory({snr - 1.0} dB)="
            f"{bound:.4f}: implementation loss > 1 dB"
        )

    def test_qam64_within_1db_of_theory(self):
        from bench.fer_sweep import theory_uncoded_fer

        snr = 21.5
        fer = self._measured(FrameConfig(10, 0, 0, 64), snr, seed=19)
        bound = theory_uncoded_fer(10, 64, snr - 1.0)
        assert fer <= bound, (
            f"QAM64 FER {fer:.4f} at {snr} dB exceeds theory({snr - 1.0} dB)="
            f"{bound:.4f}: implementation loss > 1 dB"
        )

    def test_v27_within_union_bound(self):
        """Coded-row anchor: the soft-Viterbi payload FER, conditioned on
        header acquisition (detection/header outage is bounded separately by
        the uncoded anchors), must sit below the (171,133) union bound with
        1 dB implementation-loss allowance plus small-sample slack. A broken
        soft metric (e.g. LLR sign/scale) puts the conditional FER near the
        UNCODED curve — orders of magnitude above the bound."""
        from bench.fer_sweep import theory_v27_fer_ub

        snr = 2.5
        det, hdr, ok = run_point(
            jax, jnp, FrameConfig(1, 1, 0, 64), snr, self.N, seed=23
        )
        assert hdr > 0
        cond_fer = 1.0 - ok / hdr
        bound = theory_v27_fer_ub(64, snr - 1.0)
        slack = 4.0 / hdr
        assert cond_fer <= bound + slack, (
            f"V27 conditional FER {cond_fer:.4f} at {snr} dB exceeds union "
            f"bound({snr - 1.0} dB)={bound:.5f} + slack {slack:.4f}"
        )


class TestCodedAnchors:
    """Coded-row theory anchors."""

    def test_unpunctured_spectrum_matches_published(self):
        from bench.fer_sweep import _V27_AD, conv_event_spectrum

        s = conv_event_spectrum(1, dmax=22)
        for d, a in _V27_AD.items():
            assert abs(s[d] - a) < 1e-6, (d, s.get(d), a)
        # odd weights are absent for the (171,133) code
        assert all(d % 2 == 0 for d in s)

    def test_generic_bound_matches_v27_special_case(self):
        from bench.fer_sweep import theory_conv_fer_ub, theory_v27_fer_ub

        for snr in (1.5, 2.5, 4.0):
            a = theory_conv_fer_ub(1, 1, 536, snr, dmax=22)
            b = theory_v27_fer_ub(64, snr)
            assert abs(a - b) / max(b, 1e-12) < 1e-6

    def test_punctured_spectra_exist_and_weaken(self):
        from bench.fer_sweep import conv_event_spectrum

        dfree = {}
        for ic in range(1, 7):
            s = conv_event_spectrum(ic, dmax=12)
            assert s, ic
            dfree[ic] = min(s)
        # free distance shrinks as the rate rises
        assert dfree[1] == 10
        assert dfree[2] < dfree[1]
        assert dfree[6] <= dfree[2]

    def test_outer_block_formulas_sane(self):
        from bench.fer_sweep import theory_golay_fer, theory_rs255_fer

        for f in (theory_golay_fer, theory_rs255_fer):
            lo, hi = f(64, 10.0), f(64, 0.0)
            assert 0.0 <= lo <= hi <= 1.0
            assert hi > lo  # monotone in SNR

    def test_qam_bit_error_matches_leading_term(self):
        import math

        from bench.fer_sweep import _qam_coded_bit_error, _qfunc

        p = _qam_coded_bit_error(8, 10.0)
        lead = 0.75 * _qfunc(math.sqrt(10.0 / 5.0))
        assert abs(p - lead) / lead < 0.05
