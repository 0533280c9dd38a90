"""MD forces: LJ and Coulomb nonbonded (masked all pairs under the
minimum image, or the cell list), harmonic bonds and angles, periodic
dihedrals.

Counterpart of ``njw_tpu/md/forces.py``. Forces are the negative gradient
of the total potential, by ``torch.autograd.grad`` where the JAX package
uses ``jax.grad``; the gradient runs under ``torch.enable_grad()`` on a
detached copy of the positions, so no graph outlives a call.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.md.system import LJParams, MDState, Topology
from njw_tpu_torch.platform.device import require_device

COULOMB_K = 332.06  # kcal mol^-1 A e^-2 style constant


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _rows(x, idx):
    """x[idx] for an index tensor of any shape, by ``index_select``: its
    backward adds with atomics, where the backward of ``x[idx]`` sorts the
    indices and adds each one's repeats in turn (the cell-list forces at
    20 000 atoms took 4.34 s that way on an H100, 42.4 ms this way)."""
    return x.index_select(0, idx.reshape(-1)).view(*idx.shape, *x.shape[1:])


def nonbonded_energy(pos, charge, type_id, box, lj: LJParams,
                     cutoff: float, exclusion=None):
    """Total LJ + Coulomb energy over all pairs under the minimum image,
    with a cutoff. exclusion: an optional (N, N) bool tensor of pairs to
    skip (bonded 1-2 and 1-3 pairs)."""
    n = pos.shape[0]
    d = _min_image(pos[None, :, :] - pos[:, None, :], box)
    r2 = (d * d).sum(-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = ~eye & (r2 < cutoff * cutoff)
    if exclusion is not None:
        mask = mask & ~exclusion
    r2 = torch.where(mask, r2, 1.0)  # a safe value where masked

    eps_i = lj.epsilon[type_id]
    sig_i = lj.sigma[type_id]
    eps = torch.sqrt(eps_i[:, None] * eps_i[None, :])   # Lorentz-Berthelot
    sig = 0.5 * (sig_i[:, None] + sig_i[None, :])
    s2 = (sig * sig) / r2
    s6 = s2 * s2 * s2
    e_lj = 4.0 * eps * (s6 * s6 - s6)

    inv_r = torch.rsqrt(r2)
    e_coul = COULOMB_K * charge[:, None] * charge[None, :] * inv_r

    e_pair = torch.where(mask, e_lj + e_coul, 0.0)
    return 0.5 * e_pair.sum()


def bonded_energy(pos, box, topo: Topology):
    """Harmonic bonds and angles, periodic dihedrals."""
    e = torch.zeros((), dtype=torch.float32, device=pos.device)
    if topo.bonds is not None:
        ri = _rows(pos, topo.bonds[:, 0])
        rj = _rows(pos, topo.bonds[:, 1])
        d = _min_image(rj - ri, box)
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        e = e + (0.5 * topo.bond_k * (r - topo.bond_r0) ** 2).sum()
    if topo.angles is not None:
        ri = _rows(pos, topo.angles[:, 0])
        rj = _rows(pos, topo.angles[:, 1])
        rk = _rows(pos, topo.angles[:, 2])
        a = _min_image(ri - rj, box)
        b = _min_image(rk - rj, box)
        cosang = (a * b).sum(-1) * torch.rsqrt(
            (a * a).sum(-1) * (b * b).sum(-1) + 1e-12)
        theta = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
        e = e + (0.5 * topo.angle_k * (theta - topo.angle_theta0) ** 2).sum()
    if topo.dihedrals is not None:
        ri, rj, rk, rl = (_rows(pos, topo.dihedrals[:, m]) for m in range(4))
        b1 = _min_image(rj - ri, box)
        b2 = _min_image(rk - rj, box)
        b3 = _min_image(rl - rk, box)
        n1 = torch.linalg.cross(b1, b2, dim=-1)
        n2 = torch.linalg.cross(b2, b3, dim=-1)
        m1 = torch.linalg.cross(n1, b2 * torch.rsqrt(
            (b2 * b2).sum(-1, keepdim=True) + 1e-12), dim=-1)
        x = (n1 * n2).sum(-1)
        y = (m1 * n2).sum(-1)
        phi = torch.atan2(y, x)
        e = e + (topo.dihedral_k
                 * (1.0 + torch.cos(topo.dihedral_n * phi
                                    - topo.dihedral_phase))).sum()
    return e


def _bonded_exclusion(n: int, topo: Topology) -> np.ndarray:
    """(N, N) bool mask of the 1-2 and 1-3 bonded pairs that the
    nonbonded sum skips (static, computed once)."""
    mask = np.zeros((n, n), dtype=bool)
    if topo.bonds is not None:
        b = topo.bonds.cpu().numpy()
        mask[b[:, 0], b[:, 1]] = mask[b[:, 1], b[:, 0]] = True
    if topo.angles is not None:
        a = topo.angles.cpu().numpy()
        mask[a[:, 0], a[:, 2]] = mask[a[:, 2], a[:, 0]] = True
    return mask


# The atom count from which 'auto' takes the cell list, by device. CPU:
# the JAX package's CPU choice (njw_tpu/md/forces.py). CUDA: the smallest
# N of chip_smoke.py phase 18's crossover (all pairs against the cell list
# at N = 2000, 5000, 20000) at which the cell list was faster, on an
# NVIDIA H100 80GB HBM3 at 700.00 W: 1.51 / 5.15 ms at 2000, 7.93 / 11.52
# at 5000, 121.6 / 43.5 at 20000 (PERF.md section 6).
_CELL_LIST_MIN_N_CPU = 2000
_CELL_LIST_MIN_N_CUDA = 20_000


def _cell_list_min_n(device: torch.device) -> int:
    return (_CELL_LIST_MIN_N_CUDA if device.type == "cuda"
            else _CELL_LIST_MIN_N_CPU)


def make_force_fn(topo: Topology, lj: LJParams, cutoff: float, n: int,
                  *, method: str = "auto", box_static=None,
                  pos_static=None, device="cuda"):
    """force_fn(state) -> (forces (N, 3), energies dict): the exact
    negative gradient of the total potential, on ``device``.

    method: 'all_pairs' (masked O(N^2)), 'cell_list' (fixed-capacity cell
    buckets, ``njw_tpu_torch.md.neighbors``), or 'auto' (the cell list
    from ``_cell_list_min_n`` atoms on, where the box spans >= 3 cells
    a dimension). The cell list needs box_static, the (3,) box lengths,
    to size its grid; pos_static, when given, sizes each cell's capacity
    from the measured initial occupancy. A cell past its capacity poisons
    the energy with NaN.
    """
    dev = require_device(device)
    has_bonded = topo.bonds is not None or topo.angles is not None \
        or topo.dihedrals is not None

    use_cells = False
    if method in ("auto", "cell_list") and box_static is not None:
        from njw_tpu_torch.md.neighbors import cell_list_supported

        eligible = cell_list_supported(box_static, cutoff)
        if method == "cell_list" and not eligible:
            raise ValueError("cell_list needs >= 3 cells per dim "
                             f"(box {box_static}, cutoff {cutoff})")
        use_cells = eligible and (method == "cell_list"
                                  or n >= _cell_list_min_n(dev))
    elif method == "cell_list":
        raise ValueError("cell_list requires box_static")

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if use_cells:
        from njw_tpu_torch.md.neighbors import (
            cell_grid, excluded_pair_list, excluded_pairs_energy,
            nonbonded_energy_cell_list, pick_capacity,
        )

        nc = cell_grid(box_static, cutoff)
        capacity = pick_capacity(n, box_static, nc, pos_static=pos_static)
        excl = excluded_pair_list(topo) if has_bonded else None
        excl_pairs = None if excl is None else torch.from_numpy(
            excl.astype(np.int64)).to(dev)

        def potential(pos, charge, type_id, box):
            e_nb = nonbonded_energy_cell_list(
                pos, charge, type_id, box, lj, cutoff, nc=nc,
                capacity=capacity)
            if excl_pairs is not None:
                e_nb = e_nb - excluded_pairs_energy(
                    pos, charge, type_id, box, lj, cutoff, excl_pairs)
            e_b = bonded_energy(pos, box, topo) if has_bonded else zero
            return e_nb + e_b, e_nb, e_b
    else:
        exclusion = torch.from_numpy(_bonded_exclusion(n, topo)).to(dev) \
            if has_bonded else None

        def potential(pos, charge, type_id, box):
            e_nb = nonbonded_energy(pos, charge, type_id, box, lj, cutoff,
                                    exclusion)
            e_b = bonded_energy(pos, box, topo) if has_bonded else zero
            return e_nb + e_b, e_nb, e_b

    def force_fn(s: MDState):
        with torch.enable_grad():
            pos = s.pos.detach().requires_grad_(True)
            e, e_nb, e_b = potential(pos, s.charge, s.type_id, s.box)
            g, = torch.autograd.grad(e, pos)
        return -g, {"potential": e.detach(), "nonbonded": e_nb.detach(),
                    "bonded": e_b.detach()}

    force_fn.uses_cell_list = use_cells
    return force_fn


def forces_and_energy(s: MDState, topo: Topology, lj: LJParams,
                      cutoff: float = 2.5):
    return make_force_fn(topo, lj, cutoff, s.n, device=s.pos.device)(s)
