"""N-body and MD views: counterpart of ``njw_tpu/viz/particles.py``.

Positions, masses and series may be tensors on any device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from njw_tpu_torch.viz._common import pyplot, to_numpy


def _save(fig, path):
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        pyplot().close(fig)
    return fig


def plot_particles_3d(positions, masses=None, title: str = "particles",
                      path: Optional[str] = None):
    plt = pyplot()
    pos = to_numpy(positions)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    size = 4.0
    if masses is not None:
        m = to_numpy(masses)
        size = 2 + 30 * (m - m.min()) / max(m.max() - m.min(), 1e-12)
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=size, alpha=0.6)
    ax.set_title(title)
    return _save(fig, path)


def plot_energy_history(times, energies: dict,
                        path: Optional[str] = None):
    """energies: name -> series (e.g. kinetic/potential/total)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 3.5))
    for name, series in energies.items():
        ax.plot(to_numpy(times), to_numpy(series), label=name)
    ax.set_xlabel("time")
    ax.set_ylabel("energy")
    ax.legend()
    return _save(fig, path)


def plot_trajectory(frames, particle_indices=None,
                    path: Optional[str] = None):
    """frames: list of (N, 3) position snapshots."""
    plt = pyplot()
    frames = [to_numpy(f) for f in frames]
    idx = particle_indices or range(min(16, frames[0].shape[0]))
    fig, ax = plt.subplots(figsize=(5, 5))
    for i in idx:
        xs = [f[i, 0] for f in frames]
        ys = [f[i, 1] for f in frames]
        ax.plot(xs, ys, lw=0.8, alpha=0.8)
    ax.set_title("trajectories (xy)")
    ax.set_aspect("equal")
    return _save(fig, path)


def plot_temperature(temperatures, times=None, target_temp=None,
                     path: Optional[str] = None):
    """Temperature against time with an optional target line."""
    plt = pyplot()
    temp = to_numpy(temperatures, np.float64)
    t = to_numpy(times) if times is not None else np.arange(len(temp))
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(t, temp, color="#d65f5f", label="temperature")
    if target_temp is not None:
        ax.axhline(target_temp, color="#4878cf", linestyle="--",
                   label=f"target {target_temp:g} K")
    ax.set_xlabel("time")
    ax.set_ylabel("temperature (K)")
    ax.legend()
    return _save(fig, path)
