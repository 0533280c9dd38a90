"""Image filters: 2-D convolution, gaussian, median, bilateral, non-local
means.

Counterpart of ``njw_tpu/medical/filters.py``. Each filter takes an
(H, W) image or a (B, H, W) stack of slices (the leading axes that the
JAX package vmaps over go into the batch dimension). The convolutions
run on ``F.conv2d`` inside ``float32_products()`` (cuDNN's TF32 off: the
JAX reference runs full float32); the window-rank filters build the
stack of shifted copies, edge-clamped, and reduce over it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from njw_tpu_torch.platform.precision import float32_products
from njw_tpu_torch.platform.tensors import as_tensor


def _batched(image, device):
    """(B, H, W) float32 and whether the input was 2-D."""
    img = as_tensor(image, device)
    return (img[None], True) if img.ndim == 2 else (img, False)


def _conv_same(img, ker):
    """'same' true convolution of each (H, W) slice of (B, H, W) with a
    (kh, kw) kernel: XLA's cross-correlation of the flipped kernel with
    padding (k // 2, (k - 1) // 2) on each axis."""
    kh, kw = ker.shape
    x = F.pad(img[:, None], (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    with float32_products():
        out = F.conv2d(x, ker.flip((0, 1))[None, None])
    return out[:, 0]


def convolve2d(image, kernel, *, device=None) -> torch.Tensor:
    """'same' 2-D convolution of an (H, W) image or (B, H, W) stack."""
    img, two_d = _batched(image, device)
    ker = as_tensor(kernel, img.device)
    out = _conv_same(img, ker)
    return out[0] if two_d else out


def gaussian_kernel(sigma: float, radius: int = 0) -> np.ndarray:
    r = radius or max(1, int(3 * sigma))
    x = np.arange(-r, r + 1)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _gaussian_on(sigma: float, device: torch.device) -> torch.Tensor:
    """gaussian_kernel(sigma) on ``device``, made once (a call that reuses
    it copies nothing from the host, so it can be captured in a graph)."""
    return torch.from_numpy(gaussian_kernel(sigma)).to(device)


def gaussian_filter(image, sigma: float = 1.0, *, device=None):
    img, two_d = _batched(image, device)
    out = _conv_same(img, _gaussian_on(float(sigma), img.device))
    return out[0] if two_d else out


def _shifted_stack(img, radius: int) -> torch.Tensor:
    """(K, B, H, W) stack of all window-shifted copies of (B, H, W),
    edge-clamped; K runs over (dy, dx) in row-major order."""
    h, w = img.shape[-2:]
    pad = F.pad(img[:, None], (radius,) * 4, mode="replicate")[:, 0]
    return torch.stack([
        pad[:, radius + dy: radius + dy + h, radius + dx: radius + dx + w]
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)])


def median_filter(image, size: int = 3, *, device=None) -> torch.Tensor:
    """The median of each size x size window (size odd): the middle of
    the sorted window stack."""
    img, two_d = _batched(image, device)
    stack = _shifted_stack(img, size // 2)
    out = torch.sort(stack, dim=0).values[stack.shape[0] // 2]
    return out[0] if two_d else out


@functools.lru_cache(maxsize=32)
def _offsets_on(r: int, device: torch.device) -> torch.Tensor:
    """The (K, 2) window offsets (dy, dx) of radius r on ``device``."""
    return torch.tensor(
        [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
        dtype=torch.float32, device=device)


def bilateral_filter(image, size: int = 5, sigma_space: float = 2.0,
                     sigma_intensity: float = 0.1, *,
                     device=None) -> torch.Tensor:
    img, two_d = _batched(image, device)
    r = size // 2
    stack = _shifted_stack(img, r)
    coords = _offsets_on(r, img.device)
    w_space = torch.exp(-torch.sum(coords ** 2, dim=1)
                        / (2 * sigma_space ** 2))[:, None, None, None]
    w_int = torch.exp(-((stack - img[None]) ** 2)
                      / (2 * sigma_intensity ** 2))
    w = w_space * w_int
    out = torch.sum(w * stack, dim=0) / torch.clamp_min(
        torch.sum(w, dim=0), 1e-12)
    return out[0] if two_d else out


def nlm_filter(image, search_radius: int = 5, patch_radius: int = 1,
               h: float = 0.1, *, device=None) -> torch.Tensor:
    """Non-local means: each shifted copy weighted by the box-filtered
    squared difference of its patch and the centre patch."""
    img, two_d = _batched(image, device)
    k = 2 * patch_radius + 1
    box = torch.ones((k, k), dtype=torch.float32, device=img.device)
    box = box / box.sum()
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    r = search_radius
    pad = F.pad(img[:, None], (r,) * 4, mode="replicate")[:, 0]
    H, W = img.shape[-2:]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = pad[:, r + dy: r + dy + H, r + dx: r + dx + W]
            d2 = _conv_same((img - shifted) ** 2, box)
            w = torch.exp(-d2 / (h * h))
            num = num + w * shifted
            den = den + w
    out = num / torch.clamp_min(den, 1e-12)
    return out[0] if two_d else out


_FILTERS = {
    "gaussian": gaussian_filter,
    "median": median_filter,
    "bilateral": bilateral_filter,
    "nlm": nlm_filter,
    "non_local_means": nlm_filter,
}


def apply_filter(image, method: str = "gaussian", *, device=None, **kw):
    """Filter a 2-D image, or each 2-D slice of a 3-D or 4-D one (the
    leading axes in one batch)."""
    data = image.data if hasattr(image, "modality") else image
    try:
        fn = _FILTERS[method]
    except KeyError:
        raise ValueError(
            f"unknown filter {method!r}; available: {sorted(_FILTERS)}"
        ) from None
    data = as_tensor(data, device)
    if data.ndim == 2:
        return fn(data, **kw)
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    return fn(flat, **kw).reshape(data.shape)
