"""Particle system state, factories and conserved-quantity diagnostics.

Counterpart of ``njw_tpu/nbody/system.py``: positions (N, 3), velocities
(N, 3) and masses (N,) as float32 tensors, with G and the softening
length as Python floats.

The random and galaxy factories draw with a ``torch.Generator`` seeded
from ``seed`` on the CPU and then move the tensors to the device, so one
seed names one system on either device (the JAX package draws with
``jax.random``, whose bits these cannot match: the two agree in shape,
range and distribution). The solar factory draws with NumPy as the JAX
package does and equals it bit for bit.
"""
from __future__ import annotations


import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.utils.pytree import pytree_dataclass


@pytree_dataclass
class NBodySystem:
    pos: torch.Tensor    # (N, 3)
    vel: torch.Tensor    # (N, 3)
    mass: torch.Tensor   # (N,)
    G: float = 1.0
    softening: float = 1.0e-6

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def create_random_system(
    n: int, *, box_size: float = 10.0, min_mass: float = 0.1,
    max_mass: float = 1.0, velocity_scale: float = 0.1, G: float = 1.0,
    seed: int = 0, device="cuda",
) -> NBodySystem:
    """Uniform box of random particles (positions in [-box/2, box/2))."""
    dev = require_device(device)
    gen = _generator(seed)
    pos = _uniform(gen, (n, 3), -box_size / 2, box_size / 2)
    vel = velocity_scale * torch.randn((n, 3), generator=gen)
    mass = _uniform(gen, (n,), min_mass, max_mass)
    return NBodySystem(pos=pos.to(dev), vel=vel.to(dev), mass=mass.to(dev),
                       G=float(G))


# (name, mass [solar], semi-major axis [AU]); circular orbits
_SOLAR_BODIES = [
    ("sun", 1.0, 0.0),
    ("mercury", 1.66e-7, 0.387),
    ("venus", 2.45e-6, 0.723),
    ("earth", 3.0e-6, 1.0),
    ("mars", 3.2e-7, 1.524),
    ("jupiter", 9.55e-4, 5.203),
    ("saturn", 2.86e-4, 9.537),
    ("uranus", 4.37e-5, 19.191),
    ("neptune", 5.15e-5, 30.069),
]


def create_solar_system(*, scale_factor: float = 1.0,
                        G: float = 4.0 * np.pi ** 2, seed: int = 0,
                        device="cuda") -> NBodySystem:
    """Sun and 8 planets on circular orbits in the ecliptic plane, in AU,
    years and solar masses (scale_factor scales the orbital radii)."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    pos, vel, mass = [], [], []
    for _, m, a in _SOLAR_BODIES:
        a = a * scale_factor
        theta = rng.uniform(0.0, 2 * np.pi) if a > 0 else 0.0
        pos.append([a * np.cos(theta), a * np.sin(theta), 0.0])
        if a > 0:
            v = np.sqrt(G * 1.0 / a)  # circular speed about the sun
            vel.append([-v * np.sin(theta), v * np.cos(theta), 0.0])
        else:
            vel.append([0.0, 0.0, 0.0])
        mass.append(m)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return NBodySystem(pos=t(pos), vel=t(vel), mass=t(mass), G=float(G),
                       softening=1e-6)


def create_galaxy_model(
    n: int, *, radius: float = 10.0, height: float = 1.0,
    central_mass: float = 1000.0, particle_mass: float = 1.0, G: float = 1.0,
    seed: int = 0, device="cuda",
) -> NBodySystem:
    """Disk galaxy: a massive central body and a disk of n - 1 particles
    on near-circular orbits about it."""
    dev = require_device(device)
    gen = _generator(seed)
    m = n - 1
    # radial distribution sqrt(uniform) * radius, biased toward the centre
    r = radius * torch.sqrt(_uniform(gen, (m,), 0.05, 1.0))
    theta = _uniform(gen, (m,), 0.0, 2 * np.pi)
    z = height * (torch.rand((m,), generator=gen) - 0.5)
    x, y = r * torch.cos(theta), r * torch.sin(theta)
    # circular speed about the enclosed mass (the central body's)
    v_circ = torch.sqrt(G * central_mass / r)
    v_circ = v_circ * (1.0 + 0.05 * torch.randn((m,), generator=gen))
    vx, vy = -v_circ * torch.sin(theta), v_circ * torch.cos(theta)
    zero = torch.zeros((1, 3))
    pos = torch.cat([zero, torch.stack([x, y, z], dim=1)])
    vel = torch.cat([zero, torch.stack([vx, vy, torch.zeros_like(vx)],
                                       dim=1)])
    mass = torch.cat([torch.tensor([central_mass], dtype=torch.float32),
                      torch.full((m,), particle_mass)])
    return NBodySystem(pos=pos.to(dev), vel=vel.to(dev), mass=mass.to(dev),
                       G=float(G), softening=0.05)


def system_diagnostics(s: NBodySystem) -> dict:
    """Conserved quantities: total mass, centre of mass, momentum, angular
    momentum, kinetic, potential and total energy (0-d or (3,) tensors).
    The potential is the O(N^2) pair sum: not for the particle-mesh
    paths' N (``pm_potential_energy`` is theirs)."""
    from njw_tpu_torch.nbody.forces import potential_energy

    m = s.mass[:, None]
    total_mass = s.mass.sum()
    com = (m * s.pos).sum(0) / total_mass
    momentum = (m * s.vel).sum(0)
    ang_mom = torch.linalg.cross(s.pos, m * s.vel, dim=-1).sum(0)
    ke = 0.5 * (s.mass * (s.vel * s.vel).sum(1)).sum()
    pe = potential_energy(s)
    return {
        "total_mass": total_mass, "center_of_mass": com,
        "momentum": momentum, "angular_momentum": ang_mom,
        "kinetic_energy": ke, "potential_energy": pe,
        "total_energy": ke + pe,
    }
