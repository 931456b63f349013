"""Hand-written GPU kernels and the one platform check that selects them.

Each kernel has a plain-JAX reference beside it. Library code calls
:func:`choose` with ``backend=None``: the kernel runs where JAX's default
backend is a CUDA GPU, the plain path everywhere else. Tests pass
``backend=`` explicitly, and run the kernels in Pallas interpret mode.
"""

import jax


def choose(backend: str | None, kernel: str, plain: str) -> str:
    """``backend`` if given, else ``kernel`` on a GPU and ``plain`` elsewhere."""
    if backend is not None:
        return backend
    return kernel if jax.default_backend() == "gpu" else plain
