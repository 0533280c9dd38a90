"""Point clouds: ground classification, DEM rasterization, normals,
building extraction.

Counterpart of ``njw_tpu/geospatial/point_cloud.py``. ``PointCloud`` is
the same NumPy structure of arrays; the functions bin its points onto a
grid on ``device`` (CUDA unless given) and do the rest as dense 2-D
tensor operations. The min and max rasters are ``scatter_reduce_``
("amin" / "amax", exact in any order, so equal on every device); the
mean adds by ``index_add_`` (atomics on CUDA, in no fixed order).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch
import torch.nn.functional as F

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.tensors import divide


class PointClass(IntEnum):
    """LAS-style classes."""

    UNCLASSIFIED = 1
    GROUND = 2
    LOW_VEGETATION = 3
    MEDIUM_VEGETATION = 4
    HIGH_VEGETATION = 5
    BUILDING = 6
    NOISE = 7
    WATER = 9


@dataclass
class PointCloud:
    """Structure-of-arrays point cloud (NumPy, as in the JAX package)."""

    xyz: np.ndarray                      # (N, 3) float32
    classification: np.ndarray = None    # (N,) uint8
    intensity: np.ndarray = None         # (N,)

    def __post_init__(self):
        self.xyz = np.asarray(self.xyz, np.float32)
        n = len(self.xyz)
        if self.classification is None:
            self.classification = np.full(n, PointClass.UNCLASSIFIED,
                                          np.uint8)
        if self.intensity is None:
            self.intensity = np.ones(n, np.float32)

    @property
    def n(self) -> int:
        return len(self.xyz)

    def bounds(self):
        return self.xyz.min(axis=0), self.xyz.max(axis=0)


def _xyz(pc: PointCloud, device) -> torch.Tensor:
    return torch.from_numpy(pc.xyz).to(
        require_device("cuda" if device is None else device))


def _bin_indices(xyz, cell_size, origin, shape):
    """(row, col) of each point's cell, truncated toward zero and
    clamped to the grid."""
    col = divide(xyz[:, 0] - origin[0], cell_size).to(torch.int64)
    row = divide(xyz[:, 1] - origin[1], cell_size).to(torch.int64)
    return row.clamp(0, shape[0] - 1), col.clamp(0, shape[1] - 1)


def _grid_geometry(pc: PointCloud, cell_size: float):
    lo, hi = pc.bounds()
    w = max(int(np.ceil((hi[0] - lo[0]) / cell_size)) + 1, 1)
    h = max(int(np.ceil((hi[1] - lo[1]) / cell_size)) + 1, 1)
    return (h, w), (float(lo[0]), float(lo[1]))


def _rasterize(xyz, cell_size, shape, origin, statistic):
    row, col = _bin_indices(xyz, cell_size, origin, shape)
    idx = row * shape[1] + col
    z = xyz[:, 2]
    n_cells = shape[0] * shape[1]
    if statistic in ("min", "max"):
        fill = np.inf if statistic == "min" else -np.inf
        grid = torch.full((n_cells,), fill, dtype=torch.float32,
                          device=xyz.device)
        grid.scatter_reduce_(0, idx, z, "amin" if statistic == "min"
                             else "amax", include_self=True)
        grid = grid.reshape(shape)
        return torch.where(torch.isfinite(grid), grid, np.nan)
    if statistic == "mean":
        tot = torch.zeros(n_cells, dtype=torch.float32, device=xyz.device)
        tot.index_add_(0, idx, z)
        cnt = torch.zeros(n_cells, dtype=torch.float32, device=xyz.device)
        cnt.index_add_(0, idx, torch.ones_like(z))
        grid = (tot / torch.clamp_min(cnt, 1.0)).reshape(shape)
        return torch.where(cnt.reshape(shape) > 0, grid, np.nan)
    raise ValueError(f"unknown statistic {statistic!r}")


def rasterize_dem(pc: PointCloud, cell_size: float = 1.0,
                  statistic: str = "min", *, device=None):
    """Grid the point cloud into a DEM: 'min' (ground-style), 'max'
    (surface) or 'mean' per cell, NaN where no point falls. Returns
    (grid, origin)."""
    shape, origin = _grid_geometry(pc, cell_size)
    return _rasterize(_xyz(pc, device), cell_size, shape, origin,
                      statistic), origin


def _window(g, fill_mode="replicate"):
    """(9, H, W) stack of the 3 x 3 neighbourhood, edge-clamped."""
    h, w = g.shape
    p = F.pad(g[None, None], (1, 1, 1, 1), mode=fill_mode)[0, 0]
    return torch.stack([p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _fill_nan(grid, iterations: int = 32):
    """Fill NaN cells from the mean of their finite neighbours,
    ``iterations`` times."""
    for _ in range(iterations):
        stack = _window(grid)
        ok = torch.isfinite(stack)
        cnt = torch.sum(ok, dim=0)
        mean = torch.sum(torch.where(ok, stack, 0.0), dim=0) \
            / torch.clamp_min(cnt, 1)
        grid = torch.where(torch.isnan(grid) & (cnt > 0), mean, grid)
    return grid


def _surface(xyz, cell_size, shape, origin, statistic):
    return _fill_nan(_rasterize(xyz, cell_size, shape, origin, statistic))


def classify_ground(pc: PointCloud, cell_size: float = 2.0,
                    height_threshold: float = 0.3, *,
                    device=None) -> PointCloud:
    """Points within height_threshold of the gridded minimum surface are
    GROUND; higher ones get vegetation classes by height above ground."""
    shape, origin = _grid_geometry(pc, cell_size)
    xyz = _xyz(pc, device)
    ground = _surface(xyz, cell_size, shape, origin, "min")
    row, col = _bin_indices(xyz, cell_size, origin, shape)
    hag = xyz[:, 2] - ground[row, col]  # height above ground
    cls = torch.where(
        hag <= height_threshold, int(PointClass.GROUND),
        torch.where(hag <= 2.0, int(PointClass.LOW_VEGETATION),
                    torch.where(hag <= 5.0, int(PointClass.MEDIUM_VEGETATION),
                                int(PointClass.HIGH_VEGETATION))))
    return PointCloud(pc.xyz, cls.to(torch.uint8).cpu().numpy(),
                      pc.intensity)


def _gradient(f, h: float):
    """jnp.gradient(f, h) of a 2-D field: one-sided at the edges, central
    (halved) inside, all over h; (d/dy, d/dx)."""
    out = []
    for axis in (0, 1):
        n = f.shape[axis]
        sl = f.narrow
        g = torch.cat([sl(axis, 1, 1) - sl(axis, 0, 1),
                       (sl(axis, 2, n - 2) - sl(axis, 0, n - 2)) * 0.5,
                       sl(axis, n - 1, 1) - sl(axis, n - 2, 1)], dim=axis)
        out.append(divide(g, h))
    return out


def compute_normals(pc: PointCloud, cell_size: float = 2.0, *,
                    device=None) -> np.ndarray:
    """Per-point surface normals from the gridded mean surface's gradient:
    n = normalize(-dz/dx, -dz/dy, 1). Returns (N, 3) NumPy."""
    shape, origin = _grid_geometry(pc, cell_size)
    xyz = _xyz(pc, device)
    surf = _surface(xyz, cell_size, shape, origin, "mean")
    gy, gx = _gradient(surf, cell_size)
    row, col = _bin_indices(xyz, cell_size, origin, shape)
    nx = -gx[row, col]
    ny = -gy[row, col]
    n = torch.stack([nx, ny, torch.ones_like(nx)], dim=1)
    n = n / torch.sqrt(torch.sum(n * n, dim=1, keepdim=True))
    return n.cpu().numpy()


def extract_buildings(pc: PointCloud, cell_size: float = 2.0,
                      min_height: float = 3.0, max_roughness: float = 0.5,
                      *, device=None) -> PointCloud:
    """Mark BUILDING points: high above ground and on a locally planar
    surface (roughness: the 3 x 3 standard deviation of the max-surface
    grid), roof edges grown one cell within the tall mask."""
    shape, origin = _grid_geometry(pc, cell_size)
    xyz = _xyz(pc, device)
    ground = _surface(xyz, cell_size, shape, origin, "min")
    surface = _surface(xyz, cell_size, shape, origin, "max")
    stack = _window(surface)
    mean = torch.mean(stack, dim=0)
    rough = torch.sqrt(torch.mean((stack - mean) ** 2, dim=0))
    tall = (surface - ground) >= min_height
    # planar core cells, then grown one cell within the tall mask so roof
    # edge cells (whose 3 x 3 window spans the facade jump) are included
    core = tall & (rough <= max_roughness)
    grown = torch.any(_window(core.to(torch.uint8), "constant") > 0, dim=0)
    is_building_cell = tall & grown
    row, col = _bin_indices(xyz, cell_size, origin, shape)
    hag = xyz[:, 2] - ground[row, col]
    pt = (is_building_cell[row, col] & (hag >= min_height * 0.5))
    cls = np.asarray(pc.classification).copy()
    cls[pt.cpu().numpy()] = PointClass.BUILDING
    return PointCloud(pc.xyz, cls, pc.intensity)
