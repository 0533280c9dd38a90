"""Gravitational accelerations: the direct form and the Gram-matrix form.

Counterpart of ``njw_tpu/nbody/forces.py``:

* 'direct': row blocks of explicit differences (C, N, 3); the exact
  arithmetic, the default below ``_MXU_THRESHOLD`` particles.
* 'mxu': the same sum as three float32 matrix products (the name is the
  JAX package's; on the card they are cuBLAS products):
      r2[i,j] = |p_i|^2 + |p_j|^2 - 2 p_i.p_j
      w[i,j]  = m_j (r2 + eps^2)^(-3/2),  w[i,i] = 0 (by index)
      acc_i   = G (w @ P - p_i * rowsum(w))
  The products run in full float32 (``float32_products``): TF32 would
  swamp the cancellation in ``2 p_i.p_j``. r2 is clamped at 0 and the
  self pair masked by its global index, never by value.

Rows go in blocks of ``chunk`` so the working set stays (chunk, N). The
last block is a shorter slice: the JAX package pads it with far-away
rows, which gives the same rows in its output.
"""
from __future__ import annotations

import torch

from njw_tpu_torch.nbody.system import NBodySystem
from njw_tpu_torch.platform.precision import float32_products

_DEFAULT_CHUNK = 1024
_MXU_THRESHOLD = 4096  # below this, 'auto' uses the direct form


def _acc_rows_direct(pos_rows, row0, pos, mass, G, soft2):
    """(C, 3) row block against all N: explicit differences, (C, N, 3)."""
    d = pos[None, :, :] - pos_rows[:, None, :]
    r2 = (d * d).sum(-1) + soft2
    inv_r = torch.rsqrt(r2)
    w = mass[None, :] * inv_r * inv_r * inv_r
    return G * torch.einsum("cn,cnd->cd", w, d)


def _acc_rows_mxu(pos_rows, row0, pos, mass, G, soft2):
    """(C, 3) row block against all N by Gram-matrix products."""
    c, n = pos_rows.shape[0], pos.shape[0]
    dots = pos_rows @ pos.T
    a2 = (pos_rows * pos_rows).sum(1)[:, None]
    b2 = (pos * pos).sum(1)[None, :]
    # clamp: cancellation can drive r2 slightly negative
    r2 = torch.clamp(a2 + b2 - 2.0 * dots, min=0.0) + soft2
    inv_r = torch.rsqrt(r2)
    w = mass[None, :] * inv_r * inv_r * inv_r
    rows = torch.arange(row0, row0 + c, device=pos.device)[:, None]
    cols = torch.arange(n, device=pos.device)[None, :]
    w = torch.where(rows == cols, 0.0, w)
    wp = w @ pos
    rs = w.sum(1)[:, None]
    return G * (wp - pos_rows * rs)


def accelerations(s: NBodySystem, chunk: int = _DEFAULT_CHUNK,
                  method: str = "auto", pm_box: float = 0.0,
                  pm_mesh: int = 64) -> torch.Tensor:
    """(N, 3) accelerations: row-blocked all pairs ('direct', 'mxu',
    'auto'), or the particle-mesh solvers ('pm', 'p3m': a periodic box of
    side ``pm_box``, ``njw_tpu_torch.nbody.pm``) for N >> 1e5."""
    n = s.pos.shape[0]
    if method in ("pm", "p3m"):
        from njw_tpu_torch.nbody.pm import (
            p3m_accelerations, pm_accelerations,
        )

        if pm_box <= 0:
            raise ValueError(f"method={method!r} requires pm_box "
                             "(periodic box side length)")
        fn = pm_accelerations if method == "pm" else p3m_accelerations
        return fn(s.pos, s.mass, mesh=pm_mesh, box=float(pm_box), G=s.G)
    if method == "auto":
        method = "direct" if n < _MXU_THRESHOLD else "mxu"
    if method not in ("direct", "mxu"):
        raise ValueError(f"unknown force method {method!r}")
    row_fn = _acc_rows_direct if method == "direct" else _acc_rows_mxu
    soft2 = s.softening * s.softening
    with float32_products():
        return torch.cat([
            row_fn(s.pos[r0:r0 + chunk], r0, s.pos, s.mass, s.G, soft2)
            for r0 in range(0, n, chunk)])


def potential_energy(s: NBodySystem) -> torch.Tensor:
    """PE = -G sum_{i<j} m_i m_j / r_ij, softened as the force is. Builds
    (N, N, 3): never on the particle-mesh paths."""
    d = s.pos[None, :, :] - s.pos[:, None, :]
    r2 = (d * d).sum(-1)
    n = s.pos.shape[0]
    soft2 = s.softening * s.softening
    inv_r = torch.rsqrt(r2 + soft2)
    mm = s.mass[:, None] * s.mass[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=s.pos.device)
    pair = torch.where(eye, 0.0, mm * inv_r)
    return -0.5 * s.G * pair.sum()
