"""N-body simulation: counterpart of ``njw_tpu.nbody``.

Direct O(N^2) gravity in row blocks of explicit differences or of
float32 Gram-matrix products, the particle-mesh and P3M solvers for
N >> 10^5 (cuFFT, ``index_add_`` deposits, the MD cell list for P3M's
short range), four integrators, the random, solar and galaxy factories,
and ``NBodySimulation`` with save and load. The JAX package has no Pallas
kernel here (XLA runs it), and the port runs on PyTorch's own operations.
"""
from njw_tpu_torch.nbody.system import (
    NBodySystem, create_galaxy_model, create_random_system,
    create_solar_system, system_diagnostics,
)
from njw_tpu_torch.nbody.forces import accelerations, potential_energy
from njw_tpu_torch.nbody.pm import (
    p3m_accelerations, pm_accelerations, pm_potential_energy,
)
from njw_tpu_torch.nbody.simulation import NBodySimulation

__all__ = [
    "NBodySimulation", "NBodySystem", "accelerations", "create_galaxy_model",
    "create_random_system", "create_solar_system", "p3m_accelerations",
    "pm_accelerations", "pm_potential_energy", "potential_energy",
    "system_diagnostics",
]
