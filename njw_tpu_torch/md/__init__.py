"""Molecular dynamics: counterpart of ``njw_tpu.md``.

LJ + Coulomb nonbonded forces (masked all pairs under the minimum image,
or a fixed-capacity cell list), harmonic bonds and angles, periodic
dihedrals, the exact Ewald sum, velocity Verlet, leapfrog and Beeman
integrators, Berendsen, Andersen and Nose-Hoover thermostats, the LJ
fluid and water box factories, a PDB reader and trajectory output.
Forces come from ``torch.autograd.grad`` of the potential. The JAX
package has no Pallas kernel here (XLA runs it), and the port runs on
PyTorch's own operations.
"""
from njw_tpu_torch.md.system import (
    LJParams, MDState, Topology, create_lj_fluid, create_water_box,
    kinetic_energy, load_from_pdb, temperature,
)
from njw_tpu_torch.md.forces import forces_and_energy, make_force_fn
from njw_tpu_torch.md.ewald import make_ewald_coulomb
from njw_tpu_torch.md.simulation import MDSimulation

__all__ = [
    "LJParams", "MDSimulation", "MDState", "Topology", "create_lj_fluid",
    "create_water_box", "forces_and_energy", "kinetic_energy",
    "load_from_pdb", "make_ewald_coulomb", "make_force_fn", "temperature",
]
