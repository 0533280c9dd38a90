"""Fixed-capacity cell-list neighbour pruning for the nonbonded sum.

Counterpart of ``njw_tpu/md/neighbors.py``: atoms go into cutoff-sized
cells, each holding at most ``capacity`` atoms, and LJ + Coulomb is
evaluated over the 27 neighbouring cells only:

  1. a cell id per atom (wrapped into the box)
  2. a stable sort by cell id; each atom's rank in its cell by searchsorted
  3. an (n_cells, K) atom-index table (N marks an empty slot)
  4. each atom's candidates: the table rows of its 27 neighbour cells,
     an (N, 27 K) gather, then the masked pair energy

The sort is stable (``torch.argsort(stable=True)``, as ``jnp.argsort``
is), so the table equals the JAX package's entry for entry. Ranks past
the capacity are written into a spare column that is then dropped (the
JAX package's ``mode="drop"``), with no host synchronisation, and a cell
past its capacity poisons the energy with NaN.

Bonded 1-2 and 1-3 exclusions are handled by subtracting the nonbonded
energy of the sparse excluded-pair list afterwards.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.md.forces import COULOMB_K, _min_image, _rows
from njw_tpu_torch.md.system import LJParams


def cell_grid(box, cutoff: float) -> tuple[int, int, int]:
    """Cell counts a dimension (cell edge >= cutoff)."""
    box = np.asarray(box, np.float64)
    nc = np.maximum(np.floor(box / cutoff).astype(int), 1)
    return tuple(int(c) for c in nc)


def cell_list_supported(box, cutoff: float) -> bool:
    """>= 3 cells a dimension, so the 27-cell stencil covers the cutoff
    sphere exactly once."""
    return all(c >= 3 for c in cell_grid(box, cutoff))


def build_cell_table(pos, box, nc, capacity: int):
    """(n_cells, K) atom-index table, per-atom cell coordinates (N, 3) and
    the largest cell occupancy (a 0-d tensor; check it <= capacity)."""
    ncx, ncy, ncz = nc
    n = pos.shape[0]
    dev = pos.device
    frac = pos / box - torch.floor(pos / box)      # wrapped into [0, 1)
    coords = torch.stack([
        torch.clamp((frac[:, k] * float(c)).to(torch.int64), max=c - 1)
        for k, c in enumerate(nc)], dim=1)
    cid = (coords[:, 0] * ncy + coords[:, 1]) * ncz + coords[:, 2]
    n_cells = ncx * ncy * ncz

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    starts = torch.searchsorted(sorted_cid,
                                torch.arange(n_cells, device=dev))
    rank = torch.arange(n, device=dev) - starts[sorted_cid]
    table = torch.full((n_cells, capacity + 1), n, dtype=torch.int64,
                       device=dev)
    table[sorted_cid, torch.clamp(rank, max=capacity)] = order
    counts = torch.cat([starts[1:], starts.new_full((1,), n)]) - starts
    return table[:, :capacity].contiguous(), coords, counts.max()


def neighbor_candidates(table, coords, nc) -> torch.Tensor:
    """(N, 27 K) candidate atom indices per atom (N marks an empty slot),
    the 27 cells in the JAX package's order (dx, then dy, then dz)."""
    ncx, ncy, ncz = nc
    k = torch.arange(27, device=coords.device)
    offs = torch.stack([k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1], dim=1)
    nbc = coords[:, None, :] + offs[None, :, :]            # (N, 27, 3)
    nbx = torch.remainder(nbc[..., 0], ncx)
    nby = torch.remainder(nbc[..., 1], ncy)
    nbz = torch.remainder(nbc[..., 2], ncz)
    cand = table[(nbx * ncy + nby) * ncz + nbz]            # (N, 27, K)
    return cand.reshape(cand.shape[0], -1)


def nonbonded_energy_cell_list(
    pos, charge, type_id, box, lj: LJParams, cutoff: float, *,
    nc, capacity: int,
):
    """Cell-list LJ + Coulomb total energy: the physics of
    ``forces.nonbonded_energy`` without exclusions, the pair sums
    reordered; NaN where a cell overflowed."""
    n = pos.shape[0]
    dev = pos.device
    table, coords, occ = build_cell_table(pos, box, nc, capacity)
    cand = neighbor_candidates(table, coords, nc)   # (N, M)

    pos_pad = torch.cat([pos, torch.full((1, 3), 1e9, device=dev)])
    charge_pad = torch.cat([charge, torch.zeros(1, device=dev)])
    type_pad = torch.cat([type_id, type_id.new_zeros(1)])

    d = _min_image(_rows(pos_pad, cand) - pos[:, None, :], box)
    r2 = (d * d).sum(-1)
    i_idx = torch.arange(n, device=dev)[:, None]
    mask = (cand != n) & (cand != i_idx) & (r2 < cutoff * cutoff)
    r2 = torch.where(mask, r2, 1.0)

    eps_t = lj.epsilon[type_pad]
    sig_t = lj.sigma[type_pad]
    eps = torch.sqrt(eps_t[cand] * lj.epsilon[type_id][:, None])
    sig = 0.5 * (sig_t[cand] + lj.sigma[type_id][:, None])
    s2 = (sig * sig) / r2
    s6 = s2 * s2 * s2
    e_lj = 4.0 * eps * (s6 * s6 - s6)

    inv_r = torch.rsqrt(r2)
    e_coul = COULOMB_K * charge[:, None] * charge_pad[cand] * inv_r
    e_pair = torch.where(mask, e_lj + e_coul, 0.0)
    total = 0.5 * e_pair.sum()
    # a cell past its capacity drops atoms (wrong physics): poison the
    # energy instead, so the run fails visibly
    return torch.where(occ <= capacity, total, torch.nan)


def excluded_pairs_energy(pos, charge, type_id, box, lj: LJParams,
                          cutoff: float, pairs):
    """Nonbonded energy of an explicit (P, 2) pair list (the bonded
    exclusions, subtracted from the cell-list total)."""
    i, j = pairs[:, 0], pairs[:, 1]
    d = _min_image(_rows(pos, j) - _rows(pos, i), box)
    r2 = (d * d).sum(-1)
    mask = r2 < cutoff * cutoff
    r2 = torch.where(mask, r2, 1.0)
    eps = torch.sqrt(lj.epsilon[type_id[i]] * lj.epsilon[type_id[j]])
    sig = 0.5 * (lj.sigma[type_id[i]] + lj.sigma[type_id[j]])
    s2 = (sig * sig) / r2
    s6 = s2 * s2 * s2
    e_lj = 4.0 * eps * (s6 * s6 - s6)
    e_coul = COULOMB_K * charge[i] * charge[j] * torch.rsqrt(r2)
    return torch.where(mask, e_lj + e_coul, 0.0).sum()


def excluded_pair_list(topo) -> Optional[np.ndarray]:
    """(P, 2) int32 1-2 and 1-3 pairs of the topology, each once (None if
    it has no bonds or angles)."""
    pairs = []
    if topo.bonds is not None:
        pairs.append(topo.bonds.cpu().numpy()[:, :2])
    if topo.angles is not None:
        a = topo.angles.cpu().numpy()
        pairs.append(np.stack([a[:, 0], a[:, 2]], axis=1))
    if not pairs:
        return None
    cat = np.concatenate(pairs, axis=0).astype(np.int32)
    # a 1-3 pair can coincide with a 1-2 bond (3-rings): subtract it once
    return np.unique(np.sort(cat, axis=1), axis=0)


def pick_capacity(n: int, box, nc, headroom: float = 3.0,
                  pos_static=None) -> int:
    """Per-cell capacity, a multiple of 8: headroom x the mean occupancy,
    and at least 1.5x the measured largest occupancy when the initial
    positions are given (clustered systems go far past the mean)."""
    n_cells = int(np.prod(nc))
    mean = n / max(n_cells, 1)
    cap = headroom * max(mean, 1.0)
    if pos_static is not None:
        box = np.asarray(box, np.float64)
        p = np.asarray(pos_static, np.float64)
        frac = p / box - np.floor(p / box)
        coords = np.minimum((frac * nc).astype(int), np.asarray(nc) - 1)
        cid = (coords[:, 0] * nc[1] + coords[:, 1]) * nc[2] + coords[:, 2]
        occ = np.bincount(cid, minlength=n_cells).max()
        cap = max(cap, 1.5 * occ)
    cap = int(np.ceil(cap))
    return max(8, -(-cap // 8) * 8)
