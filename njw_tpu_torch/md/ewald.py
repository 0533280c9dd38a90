"""Ewald electrostatics for periodic MD (long-range Coulomb).

Counterpart of ``njw_tpu/md/ewald.py``: the exact Ewald sum with the
reciprocal-space structure factor as dense (N, K) cos / sin matrices:

  E = E_real + E_recip + E_self
  E_real  = 1/2 sum_{i!=j, r<rc} q_i q_j erfc(alpha r) / r   (minimum image)
  E_recip = (2 pi / V) sum_{k!=0} exp(-k^2/4a^2)/k^2 |S(k)|^2
            S(k) = sum_j q_j exp(i k . r_j)
  E_self  = -alpha/sqrt(pi) sum q_i^2

Forces are the negative gradient by autograd. Units follow
``md.forces.COULOMB_K``. The phase ``pos @ kvecs.T`` reaches ~40 rad at
kmax = 6: it and the structure-factor products run in full float32
(``float32_products``), since TF32 would leave radians of error.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from njw_tpu_torch.md.forces import COULOMB_K, _min_image
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.precision import float32_products


def kvectors(box, kmax: int) -> np.ndarray:
    """(K, 3) reciprocal vectors 2 pi n / L with 0 < |n|_inf <= kmax, in a
    half space (the conjugate half is a factor 2)."""
    box = np.asarray(box, np.float64)
    ns = []
    for nx in range(0, kmax + 1):
        for ny in range(-kmax, kmax + 1):
            for nz in range(-kmax, kmax + 1):
                if nx == 0 and (ny < 0 or (ny == 0 and nz <= 0)):
                    continue  # half space, exclude 0
                ns.append((nx, ny, nz))
    n = np.asarray(ns, np.float64)
    return (2.0 * np.pi * n / box).astype(np.float32)


def ewald_energy(pos, charge, box, *, alpha: float = 1.0,
                 r_cut: float = 2.5, kvecs) -> torch.Tensor:
    """Total Ewald Coulomb energy (see the module docstring); pos,
    charge, box and kvecs are float32 tensors on one device."""
    q = charge
    n = pos.shape[0]

    # real space (minimum image, erfc-screened)
    d = _min_image(pos[None, :, :] - pos[:, None, :], box)
    r2 = (d * d).sum(-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = ~eye & (r2 < r_cut * r_cut)
    r = torch.sqrt(torch.where(mask, r2, 1.0))
    e_real = 0.5 * torch.where(
        mask, q[:, None] * q[None, :] * torch.special.erfc(alpha * r) / r,
        0.0).sum()

    # reciprocal space: S(k) by dense products
    with float32_products():
        phase = pos @ kvecs.T                      # (N, K)
        ck = torch.cos(phase)
        sk = torch.sin(phase)
        re = q @ ck                                # (K,)
        im = q @ sk
    k2 = (kvecs ** 2).sum(-1)
    vol = torch.prod(box)
    coef = torch.exp(-k2 / (4.0 * alpha * alpha)) / k2
    # factor 2: kvecs span a half space
    e_recip = (2.0 * math.pi / vol) * 2.0 * (coef * (re * re + im * im)).sum()

    e_self = -alpha / math.sqrt(math.pi) * (q * q).sum()
    return COULOMB_K * (e_real + e_recip + e_self)


def make_ewald_coulomb(box, *, alpha: float = 1.0, r_cut: float = 2.5,
                       kmax: int = 6, device="cuda"):
    """(energy_fn(pos, charge), force_fn(pos, charge)) on ``device``, the
    k-vector table made once for the (fixed) box. pos and charge may be
    tensors or arrays."""
    dev = require_device(device)
    box_np = np.asarray(box.cpu() if torch.is_tensor(box) else box)
    kv = torch.from_numpy(kvectors(box_np, kmax)).to(dev)
    box_t = torch.from_numpy(np.asarray(box_np, np.float32)).to(dev)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def energy(pos, charge):
        return ewald_energy(f32(pos), f32(charge), box_t, alpha=alpha,
                            r_cut=r_cut, kvecs=kv)

    def forces(pos, charge):
        with torch.enable_grad():
            p = f32(pos).detach().requires_grad_(True)
            g, = torch.autograd.grad(energy(p, charge), p)
        return -g

    return energy, forces


def direct_image_sum(pos, charge, box, shells: int = 3):
    """Brute-force periodic Coulomb energy over (2 shells + 1)^3 image
    cells: the slow reference for the Ewald sum (neutral cells)."""
    n = pos.shape[0]
    dev = pos.device
    eye = torch.eye(n, device=dev)
    e = 0.0
    for ix in range(-shells, shells + 1):
        for iy in range(-shells, shells + 1):
            for iz in range(-shells, shells + 1):
                off = torch.tensor([ix, iy, iz], dtype=torch.float32,
                                   device=dev) * box
                d = pos[None, :, :] + off[None, None, :] - pos[:, None, :]
                r = torch.sqrt((d * d).sum(-1)
                               + (1e-30 if (ix, iy, iz) != (0, 0, 0) else 0))
                pair = charge[:, None] * charge[None, :] / torch.where(
                    r > 1e-15, r, 1.0)
                if (ix, iy, iz) == (0, 0, 0):
                    pair = pair * (1.0 - eye)
                e = e + 0.5 * torch.where(r > 1e-15, pair, 0.0).sum()
    return COULOMB_K * e
