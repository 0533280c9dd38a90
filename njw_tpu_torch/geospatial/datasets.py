"""Synthetic geospatial datasets: fractal terrain and LiDAR-style scenes.

The port's own copy of ``njw_tpu/geospatial/datasets.py`` (NumPy only,
so its outputs are bit-equal to the JAX package's for the same seed),
for benchmarks, examples and tests.
"""
from __future__ import annotations

import numpy as np

from njw_tpu_torch.geospatial.point_cloud import PointCloud


def synthetic_dem(size: int = 512, *, roughness: float = 0.5,
                  relief: float = 100.0, seed: int = 0) -> np.ndarray:
    """Spectral-synthesis fractal terrain: power-law filtered noise
    (beta controlled by `roughness`), normalized to [0, relief]."""
    rng = np.random.default_rng(seed)
    beta = 1.5 + 2.0 * roughness
    kx = np.fft.fftfreq(size)[None, :]
    ky = np.fft.fftfreq(size)[:, None]
    k = np.sqrt(kx * kx + ky * ky)
    k[0, 0] = 1.0
    spectrum = (k ** (-beta / 2.0)) * np.exp(
        2j * np.pi * rng.random((size, size)))
    spectrum[0, 0] = 0.0
    z = np.real(np.fft.ifft2(spectrum))
    z = (z - z.min()) / (z.max() - z.min())
    return (z * relief).astype(np.float32)


def synthetic_point_cloud(n_points: int = 50_000, *, extent: float = 500.0,
                          terrain_relief: float = 30.0,
                          n_buildings: int = 10, n_trees: int = 40,
                          seed: int = 0) -> PointCloud:
    """LiDAR-style scene: terrain returns + box buildings + blob trees."""
    rng = np.random.default_rng(seed)
    dem = synthetic_dem(128, relief=terrain_relief, seed=seed)

    def ground_z(x, y):
        xi = np.clip((x / extent * 127).astype(int), 0, 127)
        yi = np.clip((y / extent * 127).astype(int), 0, 127)
        return dem[yi, xi]

    n_ground = int(n_points * 0.7)
    gx = rng.uniform(0, extent, n_ground)
    gy = rng.uniform(0, extent, n_ground)
    gz = ground_z(gx, gy) + rng.normal(0, 0.05, n_ground)
    pts = [np.stack([gx, gy, gz], axis=1)]

    n_b = int(n_points * 0.2)
    per_b = max(n_b // max(n_buildings, 1), 1)
    for _ in range(n_buildings):
        cx, cy = rng.uniform(0.1 * extent, 0.9 * extent, 2)
        w, d = rng.uniform(10, 30, 2)
        hgt = rng.uniform(5, 25)
        bx = rng.uniform(cx - w / 2, cx + w / 2, per_b)
        by = rng.uniform(cy - d / 2, cy + d / 2, per_b)
        bz = ground_z(bx, by) + hgt + rng.normal(0, 0.05, per_b)
        pts.append(np.stack([bx, by, bz], axis=1))

    n_t = int(n_points * 0.1)
    per_t = max(n_t // max(n_trees, 1), 1)
    for _ in range(n_trees):
        cx, cy = rng.uniform(0, extent, 2)
        r = rng.uniform(2, 6)
        hgt = rng.uniform(4, 15)
        tx = cx + rng.normal(0, r, per_t)
        ty = cy + rng.normal(0, r, per_t)
        tz = ground_z(np.clip(tx, 0, extent - 1e-3),
                      np.clip(ty, 0, extent - 1e-3)) \
            + rng.uniform(1.0, hgt, per_t)
        pts.append(np.stack([tx, ty, tz], axis=1))

    return PointCloud(np.concatenate(pts).astype(np.float32))
