"""Weather views: counterpart of ``njw_tpu/viz/weather.py``.

Fields may be tensors on any device (``to_numpy``); matplotlib is
imported when a view draws (``pyplot``), and a view raises its
ImportError where matplotlib is missing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from njw_tpu_torch.viz._common import pyplot, to_numpy


def _finish(fig, path: Optional[str]):
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        pyplot().close(fig)
    return fig


def visualize_field(field, title: str = "field", cmap: str = "viridis",
                    path: Optional[str] = None):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(to_numpy(field), origin="lower", cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return _finish(fig, path)


def visualize_velocity(u, v, mode: str = "quiver", stride: int = 8,
                       path: Optional[str] = None):
    """Quiver or streamline plot."""
    plt = pyplot()
    u = to_numpy(u)
    v = to_numpy(v)
    ny, nx = u.shape
    y, x = np.mgrid[0:ny, 0:nx]
    fig, ax = plt.subplots(figsize=(5, 4))
    if mode == "quiver":
        s = slice(None, None, stride)
        ax.quiver(x[s, s], y[s, s], u[s, s], v[s, s],
                  np.hypot(u, v)[s, s], cmap="coolwarm")
    elif mode == "streamlines":
        ax.streamplot(x[0], y[:, 0], u, v, color=np.hypot(u, v),
                      cmap="coolwarm", density=1.2)
    else:
        raise ValueError(f"unknown velocity plot mode {mode!r}")
    ax.set_title(f"velocity ({mode})")
    return _finish(fig, path)


def visualize_vorticity(u, v, dx: float = 1.0, dy: float = 1.0,
                        path: Optional[str] = None):
    """Relative vorticity by the NumPy oracle's centred differences."""
    from njw_tpu_torch.weather.oracle import diagnostics_np

    plt = pyplot()
    vort, _ = diagnostics_np(to_numpy(u), to_numpy(v), dx=dx, dy=dy,
                             bc="clamped")
    lim = np.abs(vort).max() or 1.0
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(vort, origin="lower", cmap="RdBu_r", vmin=-lim, vmax=lim)
    fig.colorbar(im, ax=ax)
    ax.set_title("vorticity")
    return _finish(fig, path)


def visualize_height(h, path: Optional[str] = None):
    return visualize_field(h, "height", cmap="terrain", path=path)


def animate_simulation(snapshots, field: str = "h",
                       path: Optional[str] = None, fps: int = 10):
    """An animated GIF from ``Simulation.snapshots`` (dicts of host arrays
    with a ``step``; tensors are accepted too)."""
    plt = pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    frames = [to_numpy(s[field]) for s in snapshots if field in s]
    if not frames:
        raise ValueError(f"no snapshots contain field {field!r}")
    fig, ax = plt.subplots(figsize=(5, 4))
    vmin = min(f.min() for f in frames)
    vmax = max(f.max() for f in frames)
    im = ax.imshow(frames[0], origin="lower", cmap="viridis",
                   vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax)

    def update(i):
        im.set_data(frames[i])
        ax.set_title(f"{field} @ step {snapshots[i].get('step', i)}")
        return (im,)

    anim = FuncAnimation(fig, update, frames=len(frames))
    if path:
        anim.save(path, writer=PillowWriter(fps=fps))
        plt.close(fig)
    return anim


def plot_performance(metrics: dict, path: Optional[str] = None):
    """Bar chart of a ``PerformanceMetrics.as_dict()``."""
    plt = pyplot()
    keys = [k for k, v in metrics.items()
            if isinstance(v, (int, float)) and v > 0]
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar(keys, [metrics[k] for k in keys], color="#4878cf")
    ax.set_yscale("log")
    plt.setp(ax.get_xticklabels(), rotation=25, ha="right")
    ax.set_title("performance metrics")
    return _finish(fig, path)
