"""Medical-imaging views: counterpart of ``njw_tpu/viz/imaging.py`` (the
medical colormap, images, overlay, slices, orthogonal slices, volume
animation, histogram, 3-D surface, CT projection, comparison,
difference). Images and volumes may be tensors on any device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from njw_tpu_torch.viz._common import pyplot, to_numpy


def _save(fig, path):
    if path:
        fig.savefig(path, dpi=110)
        pyplot().close(fig)
    return fig


def show_image(image, title: str = "image", cmap: str = "gray",
               path: Optional[str] = None):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    im = ax.imshow(to_numpy(image), cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


def show_sinogram(sinogram, path: Optional[str] = None):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(to_numpy(sinogram), aspect="auto", cmap="magma")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("detector")
    ax.set_ylabel("angle")
    ax.set_title("sinogram")
    fig.tight_layout()
    return _save(fig, path)


def compare_images(images: dict, cmap: str = "gray",
                   path: Optional[str] = None):
    """Side-by-side panels: name -> 2-D array."""
    plt = pyplot()
    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.4))
    if n == 1:
        axes = [axes]
    for ax, (name, img) in zip(axes, images.items()):
        ax.imshow(to_numpy(img), cmap=cmap)
        ax.set_title(name)
        ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


def create_medical_colormap():
    """Black -> deep blue -> tissue tones -> white, a radiology-style
    ramp."""
    pyplot()
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list("medical", [
        (0.0, "#000000"), (0.25, "#1a2a6c"), (0.55, "#b21f1f"),
        (0.8, "#fdbb2d"), (1.0, "#ffffff")])


def plot_overlay(image, segmentation, alpha: float = 0.5,
                 title: str = "overlay", path: Optional[str] = None):
    """Segmentation labels alpha-blended over the grayscale image. Label 0
    is transparent."""
    plt = pyplot()
    img = to_numpy(image, np.float64)
    seg = to_numpy(segmentation)
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.imshow(img, cmap="gray")
    masked = np.ma.masked_where(seg == 0, seg)
    ax.imshow(masked, cmap="tab10", alpha=alpha, interpolation="nearest")
    ax.set_title(title)
    ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


def _take_slice(volume, axis: int, index: int) -> np.ndarray:
    return np.take(to_numpy(volume), index, axis=axis)


def plot_slice(volume, axis: int = 0, slice_index: Optional[int] = None,
               title: Optional[str] = None, cmap: str = "gray",
               path: Optional[str] = None):
    """One slice of a 3-D volume (the middle one by default)."""
    plt = pyplot()
    vol = to_numpy(volume)
    if slice_index is None:
        slice_index = vol.shape[axis] // 2
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    im = ax.imshow(_take_slice(vol, axis, slice_index), cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.set_title(title or f"axis {axis}, slice {slice_index}")
    ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


def plot_orthogonal_slices(volume, center=None, cmap: str = "gray",
                           path: Optional[str] = None):
    """Axial, coronal and sagittal panels through a point."""
    plt = pyplot()
    vol = to_numpy(volume)
    if vol.ndim != 3:
        raise ValueError("plot_orthogonal_slices needs a 3-D volume")
    c = center or tuple(s // 2 for s in vol.shape)
    names = ("axial", "coronal", "sagittal")
    fig, axes = plt.subplots(1, 3, figsize=(11, 3.8))
    for ax, axis, name in zip(axes, range(3), names):
        ax.imshow(_take_slice(vol, axis, c[axis]), cmap=cmap)
        ax.set_title(f"{name} [{c[axis]}]")
        ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


def create_volume_animation(volume, axis: int = 0, fps: int = 12,
                            cmap: str = "gray",
                            path: Optional[str] = None):
    """Slice-sweep animation through a 3-D volume; saves a GIF and returns
    its path when a path is given, else returns the animation."""
    plt = pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    vol = to_numpy(volume)
    n = vol.shape[axis]
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    im = ax.imshow(_take_slice(vol, axis, 0), cmap=cmap,
                   vmin=float(vol.min()), vmax=float(vol.max()))
    ttl = ax.set_title("slice 0")
    ax.axis("off")

    def update(i):
        im.set_array(_take_slice(vol, axis, i))
        ttl.set_text(f"slice {i}")
        return [im]

    anim = FuncAnimation(fig, update, frames=n, blit=False)
    if path:
        anim.save(path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return path
    return anim


def plot_histogram(image, bins: int = 50, title: str = "histogram",
                   log_scale: bool = False,
                   path: Optional[str] = None):
    """Intensity histogram with mean and median markers."""
    plt = pyplot()
    vals = to_numpy(image, np.float64).ravel()
    fig, ax = plt.subplots(figsize=(5.5, 3.6))
    ax.hist(vals, bins=bins, color="#4878cf", edgecolor="white")
    ax.axvline(vals.mean(), color="k", linestyle="--",
               label=f"mean {vals.mean():.3g}")
    ax.axvline(np.median(vals), color="#d65f5f", linestyle=":",
               label=f"median {np.median(vals):.3g}")
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("intensity")
    ax.set_ylabel("count")
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return _save(fig, path)


def plot_surface_3d(image, threshold: Optional[float] = None,
                    cmap: str = "viridis", stride: int = 1,
                    title: str = "surface",
                    path: Optional[str] = None):
    """A 2-D image as a 3-D intensity surface, optionally floor-clipped at
    a threshold."""
    plt = pyplot()
    img = to_numpy(image, np.float64)[::stride, ::stride]
    if threshold is not None:
        img = np.where(img >= threshold, img, threshold)
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    fig = plt.figure(figsize=(6.5, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(xx, yy, img, cmap=cmap, linewidth=0,
                    antialiased=False)
    ax.set_title(title)
    fig.tight_layout()
    return _save(fig, path)


def plot_difference(image1, image2, title: str = "difference",
                    cmap: str = "RdBu",
                    path: Optional[str] = None):
    """Signed difference map with a symmetric colour scale."""
    plt = pyplot()
    diff = to_numpy(image1, np.float64) - to_numpy(image2, np.float64)
    lim = float(np.abs(diff).max()) or 1.0
    fig, ax = plt.subplots(figsize=(5, 4.2))
    im = ax.imshow(diff, cmap=cmap, vmin=-lim, vmax=lim)
    fig.colorbar(im, ax=ax, label="difference")
    ax.set_title(f"{title} (rms {np.sqrt((diff ** 2).mean()):.3g})")
    ax.axis("off")
    fig.tight_layout()
    return _save(fig, path)


# The JAX package's aliases.
plot_image = show_image
plot_images = compare_images
plot_comparison = compare_images
plot_ct_projection = show_sinogram
