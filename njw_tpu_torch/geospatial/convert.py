"""Carry point clouds and geo transforms across from the JAX package and
back.

Both packages keep a point cloud as NumPy arrays (xyz, classification,
intensity) and a ``GeoTransform`` as six floats, so a JAX object (or a
dict with its fields) is read field by field and this module imports
nothing of JAX. DEMs are plain arrays in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from njw_tpu_torch.geospatial.dem import GeoTransform
from njw_tpu_torch.geospatial.point_cloud import PointCloud


def _get(other, key):
    return other[key] if isinstance(other, dict) else getattr(other, key)


def point_cloud_from(other: Any) -> PointCloud:
    """The port's ``PointCloud`` holding copies of ``other``'s arrays."""
    return PointCloud(np.array(_get(other, "xyz"), np.float32),
                      np.array(_get(other, "classification"), np.uint8),
                      np.array(_get(other, "intensity"), np.float32))


def point_cloud_fields(pc: PointCloud) -> dict:
    """A port ``PointCloud`` as the JAX ``PointCloud``'s fields."""
    return {"xyz": pc.xyz.copy(), "classification": pc.classification.copy(),
            "intensity": pc.intensity.copy()}


def geo_transform_from(other: Any) -> GeoTransform:
    """The port's ``GeoTransform`` with ``other``'s six numbers."""
    return GeoTransform(**{f.name: float(_get(other, f.name))
                           for f in dataclasses.fields(GeoTransform)})


def geo_transform_fields(gt: GeoTransform) -> dict:
    """A port ``GeoTransform`` as a dict of the JAX one's fields."""
    return dataclasses.asdict(gt)
