"""PyTorch + CUDA port of ``njw_tpu`` for NVIDIA Hopper (H100).

The JAX package ``njw_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find, and is held against it
by ``tests/test_torch_*.py``. It imports ``torch``, ``numpy`` and the
standard library only, never ``jax`` or ``njw_tpu``.

Ported so far: the shallow-water main path (grid, initial conditions,
tendencies, integrators, the ``Simulation`` loop, the NumPy oracle and
the CLI) with one hand-written CUDA kernel for the fused RK4 step
(``ops/csrc/swe_rk4.cu``). Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
