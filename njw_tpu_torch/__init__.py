"""PyTorch + CUDA port of ``njw_tpu`` for NVIDIA Hopper (H100).

The JAX package ``njw_tpu`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find, and is held against it
by ``tests/test_torch_*.py``. It imports ``torch``, ``numpy`` and the
standard library only, never ``jax`` or ``njw_tpu``.

Ported: the whole weather package. The three planar cores through
``Simulation`` and the CLI: shallow water (grid, initial conditions,
tendencies, integrators including the semi-implicit ones, the NumPy
oracles) with the fused RK4 kernel ``ops/csrc/swe_rk4.cu`` (float32 and
bf16 tendencies, one or two steps per pass); the barotropic vorticity
core (``torch.fft`` Poisson solve) with the Arakawa stage kernel
``ops/csrc/baro_stage.cu``; the primitive equations with the whole-step
kernel ``ops/csrc/pe_rk4.cu``, the stage kernel ``ops/csrc/pe_stage.cu``
and the semi-implicit stepper. The C-grid core, two-way nesting, the
global spectral cores (``ops/sht.py``: batched float32 products over the
Legendre tables) and the icosahedral core, with their sharded forms; the
snapshot writers and checkpoints (``utils``). Every sharded path of
``parallel`` (the kernel-backed steppers, the plain steppers with the
halo exchange overlapped, the sharded barotropic core on the
distributed FFT, the latitude-sharded sphere and the panel-pair
icosahedron) and the scaling harness of ``bench``; and the whole
``signal`` package: FIR filtering with the banded-product tensor-core
kernels ``ops/csrc/fir_band.cu`` and ``ops/csrc/fir_band_bf16.cu``, IIR
design and application, median and adaptive filters, spectral and
time-frequency analysis; and the ``nbody`` and ``md`` packages: direct,
Gram-product, particle-mesh and P3M gravity, LJ + Coulomb forces by
autograd over all pairs or a cell list, Ewald sums, integrators,
thermostats and both CLIs; and the ``medical`` and ``geospatial``
packages: CT (Radon, FBP, SIRT, cone-beam FDK), MRI (gridding,
CG-SENSE, primal-dual, FISTA, homodyne), filters, segmentation,
registration, DEM sweeps, hydrology, viewsheds and point clouds; and the
``geofinancial`` package: terrain risk factors, scenario, regional and
climate analysis, Monte-Carlo VaR and wealth, option prices and Greeks;
and the framework shell: ``utils`` (pytree dataclasses, configs,
profiling, checkpoints, sharded ones on ``torch.distributed.checkpoint``),
``platform`` (devices, meshes), ``bench`` (the benchmark suite, cost
models, reports, CLI), ``native`` (the ctypes loader of the C++ host
library) and ``interop`` (shared memory, device buffers, transfers); and
``viz`` (the views and HTML reports, matplotlib imported only to draw),
``dashboard`` (the stdlib HTTP dashboard with its geo-financial views)
and ``examples`` (one module per script of ``examples/``). With these,
every module of the JAX package has its counterpart here; the Pallas FIR
kernels of ``signal/fir_pallas.py`` are served by ``signal/fir_cuda.py``. All
kernels are CUDA C++ written by hand for sm_90a, and every Pallas kernel
of the JAX package has its counterpart; the global cores, nesting, the
C-grid, the signal package beyond FIR, N-body, MD, medical imaging,
geospatial analysis and the geo-financial package run on PyTorch's own
operations (the JAX package
runs them on XLA, with no Pallas kernel). Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
