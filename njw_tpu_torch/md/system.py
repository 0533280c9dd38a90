"""MD state, topology and system factories.

Counterpart of ``njw_tpu/md/system.py``. Reduced LJ units by default
(epsilon, sigma, mass = 1, kB = 1); the water box uses its own consistent
constant set.

The lattices, the water geometry and the PDB reader are deterministic or
drawn with NumPy as in the JAX package, and equal it bit for bit. The
Maxwell velocities are drawn with a ``torch.Generator`` seeded from
``seed`` on the CPU and then moved to the device, so one seed names one
state on either device (the JAX package's ``jax.random`` bits cannot be
matched: the two agree in distribution).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.utils.pytree import pytree_dataclass

KB = 1.0  # reduced units


@pytree_dataclass
class LJParams:
    """Per-type LJ parameters; pairs mix by Lorentz-Berthelot."""

    epsilon: torch.Tensor  # (T,)
    sigma: torch.Tensor    # (T,)


@pytree_dataclass
class Topology:
    """Static bonded topology: index tensors (int64) and parameters."""

    bonds: Optional[torch.Tensor] = None           # (B, 2)
    bond_k: Optional[torch.Tensor] = None          # (B,)
    bond_r0: Optional[torch.Tensor] = None         # (B,)
    angles: Optional[torch.Tensor] = None          # (A, 3), j central
    angle_k: Optional[torch.Tensor] = None         # (A,)
    angle_theta0: Optional[torch.Tensor] = None    # (A,)
    dihedrals: Optional[torch.Tensor] = None       # (D, 4)
    dihedral_k: Optional[torch.Tensor] = None      # (D,)
    dihedral_n: Optional[torch.Tensor] = None      # (D,) periodicity
    dihedral_phase: Optional[torch.Tensor] = None  # (D,)


@pytree_dataclass
class MDState:
    pos: torch.Tensor      # (N, 3)
    vel: torch.Tensor      # (N, 3)
    mass: torch.Tensor     # (N,)
    charge: torch.Tensor   # (N,)
    type_id: torch.Tensor  # (N,) int64 into LJParams
    box: torch.Tensor      # (3,) periodic box lengths

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def kinetic_energy(s: MDState) -> torch.Tensor:
    return 0.5 * (s.mass * (s.vel * s.vel).sum(1)).sum()


def temperature(s: MDState) -> torch.Tensor:
    """T = 2 KE / (3 N kB) (no constraint degrees of freedom)."""
    dof = 3 * s.pos.shape[0]
    return 2.0 * kinetic_energy(s) / (dof * KB)


def _maxwell_velocities(seed: int, n: int, mass, T0: float):
    """(N, 3) Maxwell velocities at T0 with zero net momentum, on the CPU
    (mass: a CPU float32 tensor)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    v = torch.randn((n, 3), generator=gen)
    v = v * torch.sqrt(KB * T0 / mass[:, None])
    return v - v.mean(0, keepdim=True)


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev)


def _i64(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64)).to(dev)


def create_lj_fluid(n: int, *, density: float = 0.8, T0: float = 1.0,
                    epsilon: float = 1.0, sigma: float = 1.0,
                    mass: float = 1.0, seed: int = 0, device="cuda"):
    """Cubic-lattice LJ fluid at a reduced density and temperature:
    (state, topology, lj)."""
    dev = require_device(device)
    n_side = int(np.ceil(n ** (1 / 3)))
    L = float((n / density) ** (1 / 3))
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (grid[:n] + 0.5) * (L / n_side)
    m = torch.full((n,), mass, dtype=torch.float32)
    state = MDState(
        pos=_f32(pos, dev),
        vel=_maxwell_velocities(seed, n, m, T0).to(dev),
        mass=m.to(dev),
        charge=torch.zeros(n, device=dev),
        type_id=torch.zeros(n, dtype=torch.int64, device=dev),
        box=torch.full((3,), L, device=dev),
    )
    lj = LJParams(epsilon=_f32([epsilon], dev), sigma=_f32([sigma], dev))
    return state, Topology(), lj


# SPC-like flexible water constants (a reduced-consistent set)
_WATER = dict(
    mass_o=16.0, mass_h=1.0, q_o=-0.82, q_h=0.41,
    eps_o=0.65, sig_o=3.166, r_oh=1.0, theta_hoh=1.91,  # ~109.47 deg
    k_bond=450.0, k_angle=55.0,
)


def create_water_box(n_molecules: int, *, box_size: Optional[float] = None,
                     T0: float = 1.0, seed: int = 0, device="cuda"):
    """Flexible 3-site water: harmonic O-H bonds and H-O-H angle, LJ on
    O, point charges: (state, topology, lj)."""
    dev = require_device(device)
    w = _WATER
    n = 3 * n_molecules
    if box_size is None:
        box_size = float(max(4.0, (n_molecules * 30.0) ** (1 / 3)))
    rng = np.random.default_rng(seed)
    n_side = int(np.ceil(n_molecules ** (1 / 3)))
    pos = np.zeros((n, 3), np.float32)
    for i in range(n_molecules):
        iz, iy, ix = np.unravel_index(i, (n_side,) * 3)
        c = ((np.array([ix, iy, iz]) + 0.5) / n_side) * box_size
        # O at the centre, the two H at bond length, random orientation
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        v = np.cross(u, rng.standard_normal(3))
        v /= np.linalg.norm(v)
        half = w["theta_hoh"] / 2
        h1 = np.cos(half) * u + np.sin(half) * v
        h2 = np.cos(half) * u - np.sin(half) * v
        pos[3 * i] = c
        pos[3 * i + 1] = c + w["r_oh"] * h1
        pos[3 * i + 2] = c + w["r_oh"] * h2

    mass = np.tile([w["mass_o"], w["mass_h"], w["mass_h"]], n_molecules)
    charge = np.tile([w["q_o"], w["q_h"], w["q_h"]], n_molecules)
    type_id = np.tile([0, 1, 1], n_molecules)

    bonds, angles = [], []
    for i in range(n_molecules):
        o, h1, h2 = 3 * i, 3 * i + 1, 3 * i + 2
        bonds += [[o, h1], [o, h2]]
        angles.append([h1, o, h2])
    topo = Topology(
        bonds=_i64(bonds, dev),
        bond_k=torch.full((len(bonds),), w["k_bond"], device=dev),
        bond_r0=torch.full((len(bonds),), w["r_oh"], device=dev),
        angles=_i64(angles, dev),
        angle_k=torch.full((len(angles),), w["k_angle"], device=dev),
        angle_theta0=torch.full((len(angles),), w["theta_hoh"], device=dev),
    )
    lj = LJParams(epsilon=_f32([w["eps_o"], 0.0], dev),
                  sigma=_f32([w["sig_o"], 1.0], dev))
    m = torch.from_numpy(mass.astype(np.float32))
    state = MDState(
        pos=_f32(pos, dev),
        vel=_maxwell_velocities(seed, n, m, T0).to(dev),
        mass=m.to(dev),
        charge=_f32(charge, dev),
        type_id=_i64(type_id, dev),
        box=torch.full((3,), box_size, device=dev),
    )
    return state, topo, lj


_ELEMENT_MASS = {"H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999,
                 "S": 32.06, "P": 30.974}


def load_from_pdb(path: str, *, box_size: Optional[float] = None,
                  T0: float = 0.0, seed: int = 0, device="cuda"):
    """Minimal PDB reader: ATOM/HETATM records to positions and element
    masses, no topology: (state, topology, lj)."""
    dev = require_device(device)
    pos, mass, elem = [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith(("ATOM", "HETATM")):
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                e = (line[76:78].strip() or line[12:16].strip()[:1]).upper()
                pos.append([x, y, z])
                elem.append(e)
                mass.append(_ELEMENT_MASS.get(e, 12.0))
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    if box_size is None:
        span = pos.max(axis=0) - pos.min(axis=0)
        box_size = float(span.max() * 1.5 + 10.0)
    types = sorted(set(elem))
    tid = np.asarray([types.index(e) for e in elem], np.int64)
    m = torch.from_numpy(np.asarray(mass, np.float32))
    vel = (_maxwell_velocities(seed, n, m, T0) if T0 > 0
           else torch.zeros((n, 3)))
    state = MDState(
        pos=_f32(pos - pos.min(axis=0) + 1.0, dev),
        vel=vel.to(dev),
        mass=m.to(dev),
        charge=torch.zeros(n, device=dev),
        type_id=_i64(tid, dev),
        box=torch.full((3,), box_size, device=dev),
    )
    lj = LJParams(epsilon=torch.full((len(types),), 0.2, device=dev),
                  sigma=torch.full((len(types),), 3.0, device=dev))
    return state, Topology(), lj
