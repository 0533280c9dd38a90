"""Segmentation: thresholds (fixed, Otsu, adaptive), region growing,
watershed, Chan-Vese level set, MRF labelling.

Counterpart of ``njw_tpu/medical/segmentation.py``. The iterative
methods run a fixed count of host iterations of whole-image operations
with no host read. A neighbour shift with a filled edge (JAX's
``roll(...).at[-1, :].set(fill)``) is a shifted copy with its edge row
or column set; the watershed's first-of-equal-minima neighbour is picked
by comparisons in neighbour order (what ``argmin`` and
``take_along_axis`` give), so the labels come out the same on every
device.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.medical.filters import gaussian_filter
from njw_tpu_torch.platform.tensors import as_tensor, to_numpy

_PI_5 = float(np.float32(np.pi / 5.0))


def threshold(image, value: float, high=1.0, low=0.0, *, device=None):
    """Binary threshold: high where image >= value, else low."""
    img = as_tensor(image, device)
    return torch.where(img >= value, high, low)


def otsu_threshold(image, n_bins: int = 256) -> float:
    """Otsu's method: maximise the between-class variance over the
    histogram (NumPy, float64)."""
    a = to_numpy(image).astype(np.float64).ravel()
    lo, hi = a.min(), a.max()
    if hi <= lo:
        return float(lo)
    hist, edges = np.histogram(a, bins=n_bins, range=(lo, hi))
    p = hist / hist.sum()
    centers = 0.5 * (edges[:-1] + edges[1:])
    w0 = np.cumsum(p)
    mu = np.cumsum(p * centers)
    mu_t = mu[-1]
    w1 = 1.0 - w0
    valid = (w0 > 0) & (w1 > 0)
    sigma_b = np.zeros(n_bins)
    sigma_b[valid] = ((mu_t * w0 - mu)[valid] ** 2) / (w0 * w1)[valid]
    # a bimodal histogram gives a plateau of equally good thresholds
    # between the modes: take its midpoint, not its first bin
    best = np.flatnonzero(sigma_b >= sigma_b.max() - 1e-12)
    return float(centers[int(best.mean())])


def adaptive_threshold(image, block_sigma: float = 5.0, offset: float = 0.0,
                       n_iterations: int = 0, *, device=None):
    """Each pixel against its local gaussian mean."""
    img = as_tensor(image, device)
    local_mean = gaussian_filter(img, block_sigma)
    return torch.where(img >= local_mean + offset, 1.0, 0.0)


def _shift(arr, axis: int, step: int, fill):
    """arr moved by ``step`` (+1 or -1) along ``axis`` (0 or 1): out[i] =
    arr[i - step], the edge the shift leaves empty set to ``fill``."""
    out = torch.empty_like(arr)
    n = arr.shape[axis]
    src = arr.narrow(axis, 0, n - 1) if step > 0 else arr.narrow(axis, 1,
                                                                 n - 1)
    out.narrow(axis, 1 if step > 0 else 0, n - 1).copy_(src)
    out.narrow(axis, 0 if step > 0 else n - 1, 1).fill_(fill)
    return out


def _neighbours(arr, fill):
    """(up, down, left, right): JAX's roll(arr, -1, 0), roll(arr, 1, 0),
    roll(arr, -1, 1), roll(arr, 1, 1) with the wrapped edge set to fill."""
    return (_shift(arr, 0, -1, fill), _shift(arr, 0, 1, fill),
            _shift(arr, 1, -1, fill), _shift(arr, 1, 1, fill))


def region_growing(image, seed_yx, tolerance: float = 0.1,
                   n_iterations: int = 256, *, device=None):
    """Grow a region from a seed by iterated masked dilation; criterion
    |pixel - seed value| <= tolerance."""
    img = as_tensor(image, device)
    sy, sx = seed_yx
    eligible = torch.abs(img - img[sy, sx]) <= tolerance
    region = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    region[sy, sx].fill_(True)     # a fill kernel: no copy from the host
    for _ in range(n_iterations):
        up, dn, lf, rt = _neighbours(region, False)
        region = (region | up | dn | lf | rt) & eligible
    return region.to(torch.float32)


def watershed(image, markers, n_iterations: int = 256, *, device=None):
    """Marker-based watershed by flooding: each unlabelled pixel takes the
    label of its lowest labelled neighbour (the first of equal ones, in
    up, down, left, right order), n_iterations sweeps. markers: int
    array, 0 = unlabelled."""
    img = as_tensor(image, device)
    labels = as_tensor(markers, img.device, torch.int32)
    big = 3.4e38
    ne = _neighbours(img, big)
    for _ in range(n_iterations):
        nl = _neighbours(labels, 0)
        best_e = torch.where(nl[0] > 0, ne[0], big)
        best_l = nl[0]
        for k in range(1, 4):
            e = torch.where(nl[k] > 0, ne[k], big)
            lower = e < best_e
            best_e = torch.where(lower, e, best_e)
            best_l = torch.where(lower, nl[k], best_l)
        labels = torch.where((labels == 0) & (best_e < big), best_l, labels)
    return labels


def _curvature(p):
    up, dn = torch.roll(p, -1, 0), torch.roll(p, 1, 0)
    py = (up - dn) / 2
    px = (torch.roll(p, -1, 1) - torch.roll(p, 1, 1)) / 2
    pyy = up - 2 * p + dn
    pxx = torch.roll(p, -1, 1) - 2 * p + torch.roll(p, 1, 1)
    pxy = (torch.roll(up, -1, 1) - torch.roll(up, 1, 1)
           - torch.roll(dn, -1, 1) + torch.roll(dn, 1, 1)) / 4
    denom = (px ** 2 + py ** 2) ** 1.5 + 1e-8
    return (pxx * py ** 2 - 2 * px * py * pxy + pyy * px ** 2) / denom


def chan_vese(image, n_iterations: int = 100, mu: float = 0.2,
              dt: float = 0.5, *, device=None):
    """Chan-Vese active contour by level-set evolution from a
    checkerboard; returns the binary mask."""
    img = as_tensor(image, device)
    img = (img - img.min()) / torch.clamp_min(img.max() - img.min(), 1e-9)
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    # XLA folds JAX's ``yy * pi / 5.0`` into one product by float32(pi / 5)
    phi = torch.sin(yy * _PI_5) * torch.sin(xx * _PI_5)
    for _ in range(n_iterations):
        inside = phi > 0
        c1 = torch.sum(torch.where(inside, img, 0.0)) / torch.clamp_min(
            torch.sum(inside), 1)
        c2 = torch.sum(torch.where(~inside, img, 0.0)) / torch.clamp_min(
            torch.sum(~inside), 1)
        force = -(img - c1) ** 2 + (img - c2) ** 2 + mu * _curvature(phi)
        # smoothed delta: the update stays near the front
        delta = 1.0 / (1.0 + phi ** 2)
        phi = phi + dt * delta * force
    return (phi > 0).to(torch.float32)


def mrf_segment(image, threshold_value: float, beta: float = 1.0,
                n_iterations: int = 20, *, device=None):
    """Binary MRF labelling by iterated conditional modes: data term
    (I - mu_label)^2, smoothness beta * #disagreeing neighbours."""
    img = as_tensor(image, device)
    labels = (img >= threshold_value).to(torch.float32)
    for _ in range(n_iterations):
        mu1 = torch.sum(img * labels) / torch.clamp_min(torch.sum(labels), 1)
        mu0 = torch.sum(img * (1 - labels)) / torch.clamp_min(
            torch.sum(1 - labels), 1)
        nb_sum = (torch.roll(labels, 1, 0) + torch.roll(labels, -1, 0)
                  + torch.roll(labels, 1, 1) + torch.roll(labels, -1, 1))
        e1 = (img - mu1) ** 2 + beta * (4 - nb_sum)
        e0 = (img - mu0) ** 2 + beta * nb_sum
        labels = (e1 < e0).to(torch.float32)
    return labels


def _threshold(img, value=None, device=None, **kw):
    return threshold(img, otsu_threshold(img) if value is None else value,
                     device=device, **kw)


def _mrf(img, device=None, **kw):
    return mrf_segment(img, kw.pop("threshold_value", otsu_threshold(img)),
                       device=device, **kw)


_METHODS = {
    "threshold": _threshold,
    "otsu": lambda img, device=None, **kw: threshold(
        img, otsu_threshold(img), device=device),
    "adaptive": adaptive_threshold,
    "region_growing": region_growing,
    "watershed": watershed,
    "level_set": chan_vese,
    "chan_vese": chan_vese,
    "graph_cut": _mrf,
    "mrf": _mrf,
}


def apply_segmentation(image, method: str = "otsu", *, device=None, **kw):
    """Segment a 2-D image by one of the methods above."""
    data = image.data if hasattr(image, "modality") else image
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown segmentation {method!r}; available: {sorted(_METHODS)}"
        ) from None
    return fn(data, device=device, **kw)
