"""Geospatial views: counterpart of ``njw_tpu/viz/geospatial.py`` (DEM
and terrain renders, viewshed overlays, derivatives, flow accumulation,
point clouds, 3-D terrain, least-cost paths, and an HTML report).

``hillshade`` is numeric: it runs in float64 on the DEM's device (a
tensor stays on its device; other input is computed on the CPU) and
needs no matplotlib. The views draw with matplotlib and raise its
ImportError where it is missing; ``generate_geospatial_report`` then
writes its page with the metrics table and no images.
"""
from __future__ import annotations

import html
import os
from typing import Optional

import numpy as np
import torch

from njw_tpu_torch.viz._common import have_matplotlib, pyplot, to_numpy


def hillshade(dem, azimuth_deg: float = 315.0,
              altitude_deg: float = 45.0) -> np.ndarray:
    """Lambertian hillshade in [0, 1] (the standard DEM render), as a host
    float64 array."""
    d = (dem.detach().to(torch.float64) if isinstance(dem, torch.Tensor)
         else torch.from_numpy(np.asarray(dem, np.float64)))
    gy, gx = torch.gradient(d)
    slope = np.pi / 2.0 - torch.atan(torch.hypot(gx, gy))
    aspect = torch.atan2(-gx, gy)
    az = np.radians(azimuth_deg)
    alt = np.radians(altitude_deg)
    shaded = (np.sin(alt) * torch.sin(slope)
              + np.cos(alt) * torch.cos(slope) * torch.cos(az - aspect))
    return to_numpy(torch.clip((shaded + 1.0) / 2.0, 0.0, 1.0))


def plot_dem(dem, path: str, *, title: str = "DEM",
             with_hillshade: bool = True) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(to_numpy(dem), cmap="terrain", origin="lower")
    if with_hillshade:
        ax.imshow(hillshade(dem), cmap="gray", alpha=0.35, origin="lower")
    fig.colorbar(im, ax=ax, label="elevation")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_viewshed(dem, visible, observer_xy, path: str) -> str:
    """Viewshed overlay: visible cells tinted over the hillshade."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.imshow(hillshade(dem), cmap="gray", origin="lower")
    vis = np.ma.masked_where(~to_numpy(visible).astype(bool),
                             np.ones_like(to_numpy(dem)))
    ax.imshow(vis, cmap="autumn", alpha=0.45, origin="lower")
    ax.plot(observer_xy[0], observer_xy[1], "b^", markersize=10,
            label="observer")
    ax.legend(loc="upper right")
    ax.set_title("viewshed")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_terrain_derivatives(slope, aspect, path: str) -> str:
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    im0 = axes[0].imshow(to_numpy(slope), cmap="viridis", origin="lower")
    axes[0].set_title("slope")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(to_numpy(aspect), cmap="twilight", origin="lower")
    axes[1].set_title("aspect")
    fig.colorbar(im1, ax=axes[1])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_flow_accumulation(flow_acc, path: str) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.log1p(to_numpy(flow_acc, np.float64)),
                   cmap="Blues", origin="lower")
    fig.colorbar(im, ax=ax, label="log(1 + accumulation)")
    ax.set_title("flow accumulation")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_point_cloud(points, path: str, *, classes=None,
                     max_points: int = 50_000) -> str:
    """Top-down scatter coloured by elevation or class."""
    plt = pyplot()
    pts = to_numpy(points)
    if classes is not None:
        classes = to_numpy(classes)
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts = pts[sel]
        classes = None if classes is None else classes[sel]
    fig, ax = plt.subplots(figsize=(6, 5))
    c = pts[:, 2] if classes is None else classes
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=c, s=1,
                    cmap="viridis" if classes is None else "tab10")
    fig.colorbar(sc, ax=ax,
                 label="elevation" if classes is None else "class")
    ax.set_title("point cloud")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_terrain_3d(dem, path: str, *, stride: int = 4,
                      elev: float = 55.0, azim: float = -60.0) -> str:
    """3-D surface render."""
    plt = pyplot()
    d = to_numpy(dem)[::stride, ::stride]
    y, x = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(x, y, d, cmap="terrain", linewidth=0,
                    antialiased=False)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title("terrain")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_least_cost_path(dem, path_cells, path: str) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.imshow(hillshade(dem), cmap="gray", origin="lower")
    pc = to_numpy(path_cells)
    ax.plot(pc[:, 1], pc[:, 0], "r-", linewidth=2, label="least-cost path")
    ax.plot(pc[0, 1], pc[0, 0], "go", label="start")
    ax.plot(pc[-1, 1], pc[-1, 0], "bs", label="end")
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def generate_geospatial_report(output_dir: str, dem, *,
                               visible=None, observer_xy=(0, 0),
                               slope=None, aspect=None, flow_acc=None,
                               points=None,
                               metrics: Optional[dict] = None) -> str:
    """Every applicable view and an HTML index. Without matplotlib the
    index holds the metrics table alone."""
    os.makedirs(output_dir, exist_ok=True)
    j = os.path.join
    plots = []
    if have_matplotlib():
        plots = [plot_dem(dem, j(output_dir, "dem.png")),
                 render_terrain_3d(dem, j(output_dir, "terrain3d.png"))]
        if visible is not None:
            plots.append(plot_viewshed(dem, visible, observer_xy,
                                       j(output_dir, "viewshed.png")))
        if slope is not None and aspect is not None:
            plots.append(plot_terrain_derivatives(
                slope, aspect, j(output_dir, "derivatives.png")))
        if flow_acc is not None:
            plots.append(plot_flow_accumulation(
                flow_acc, j(output_dir, "flow.png")))
        if points is not None:
            plots.append(plot_point_cloud(points,
                                          j(output_dir, "points.png")))
    rows = ""
    if metrics:
        rows = "".join(f"<tr><td>{html.escape(str(k))}</td>"
                       f"<td>{v:.6g}</td></tr>"
                       for k, v in metrics.items() if v is not None)
    imgs = "".join(f'<img src="{os.path.basename(p)}" '
                   'style="max-width:48%">' for p in plots)
    page = ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>geospatial report</title></head><body>"
            "<h1>geospatial report</h1>"
            + (f"<table border=1>{rows}</table>" if rows else "")
            + imgs + "</body></html>")
    out = j(output_dir, "index.html")
    with open(out, "w") as fh:
        fh.write(page)
    return out
