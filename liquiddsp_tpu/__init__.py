"""liquiddsp_tpu — a batched, accelerator-resident adaptive flexframe PHY.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
gr-liquiddsp (a GNU Radio OOT module wrapping liquid-dsp; see SURVEY.md):

- ``ops``     — batched DSP/coding primitives (msequence, CRC, modems, FEC,
                RRC filters, AGC, NCO) as pure JAX functions.
- ``kernels`` — Pallas kernels (Triton route) for the hot inner loops
                on a GPU (preamble correlator, Viterbi), each with a
                plain-JAX path that runs everywhere else.
- ``phy``     — the flexframe PHY: framegen (TX), framesync (RX),
                frame detector (batched, block-based — not per-sample).
- ``runtime`` — streaming orchestrator, message bus, block-level API mirroring
                the reference's flex_tx / flex_rx / frame_detector_cc blocks.
- ``parallel``— device-mesh sharding: channel parallelism and time-block
                sharding with ppermute halo exchange.
- ``engine``  — the cognitive engine: 616-arm configuration space, bandit
                algorithms (epsilon-greedy, annealing, Gittins, RoTA, meta),
                knowledge indicators, persistence.

The reference's integer parameter spaces are preserved exactly:
11 modulations x 7 inner FEC x 8 outer FEC = 616 configurations
(reference: lib/flex_tx_impl.cc:76-181, python/cognitive_engine.py:525-533).
"""

__version__ = "0.1.0"

from liquiddsp_tpu.core.config import (  # noqa: F401
    Modulation,
    InnerCode,
    OuterCode,
    FrameConfig,
    ConfigurationMap,
    NUM_MODULATIONS,
    NUM_INNER_CODES,
    NUM_OUTER_CODES,
    NUM_CONFIGS,
)
