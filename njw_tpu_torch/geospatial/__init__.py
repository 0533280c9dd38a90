"""Geospatial analysis: counterpart of ``njw_tpu.geospatial``.

DEM processing (terrain derivatives, viewshed by a radial sweep, sink
filling and cost distance by fast-sweeping line scans, D8 flow direction
and accumulation, least-cost paths, resampling, statistics,
``DEMProcessor``) and point clouds (rasterized DEMs, ground
classification, normals, building extraction), with the synthetic
datasets and the metrics recorder. The JAX package has no Pallas kernel
here (XLA runs it), and the port runs on PyTorch's own operations:
stencils as shifted slices, cumulative scans, an associative scan,
gathers, ``scatter_reduce_`` and ``index_add_``. A function takes
tensors (which stay on their device) or NumPy arrays (which go to
``device``, CUDA unless given).
"""
from njw_tpu_torch.geospatial.dem import (
    DEMProcessor, GeoTransform, cost_distance, dem_statistics, fill_sinks,
    flow_accumulation, flow_direction, least_cost_path, resample,
    terrain_derivatives, viewshed,
)
from njw_tpu_torch.geospatial.point_cloud import (
    PointCloud, classify_ground, compute_normals, extract_buildings,
    rasterize_dem,
)

__all__ = [
    "DEMProcessor", "GeoTransform", "PointCloud", "classify_ground",
    "compute_normals", "cost_distance", "dem_statistics",
    "extract_buildings", "fill_sinks", "flow_accumulation",
    "flow_direction", "least_cost_path", "rasterize_dem", "resample",
    "terrain_derivatives", "viewshed",
]
