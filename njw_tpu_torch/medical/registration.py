"""Image registration: differentiable warping and metric-driven
optimisation.

Counterpart of ``njw_tpu/medical/registration.py``. The warp is
differentiable bilinear resampling, the metric (MSE, or mutual
information from Parzen soft histograms) a scalar tensor, and the
parameters are stepped by gradient descent or Adam on
``torch.autograd.grad`` of the metric (``jax.grad`` in the JAX package).
Each iteration's loss stays on the device until the loop ends, so the
loops read the host once. The deformable form's control-grid gathers
carry a gradient and go through ``index_select`` (the backward of plain
indexing with repeated indices serialises on CUDA); its Adam is optax's
update written out, with optax's float32 bias corrections.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.medical.ct import _bilinear
from njw_tpu_torch.platform.precision import float32_products
from njw_tpu_torch.platform.tensors import (
    as_tensor, device_of, divide, linspace32,
)


def _affine_grid(h, w, params):
    """params = [ty, tx, theta, sy, sx] -> sample coords (ys, xs), each
    (H, W)."""
    ty, tx, theta, sy, sx = (params[i] for i in range(5))
    dev = params.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y = (yy - cy) / torch.clamp_min(sy, 1e-3)
    x = (xx - cx) / torch.clamp_min(sx, 1e-3)
    ct, st = torch.cos(-theta), torch.sin(-theta)
    ys = y * ct - x * st + cy - ty
    xs = y * st + x * ct + cx - tx
    return ys, xs


def warp_image(image, params, *, device=None):
    """Rigid/affine warp; params = [ty, tx, theta, sy, sx]."""
    img = as_tensor(image, device)
    ys, xs = _affine_grid(*img.shape, as_tensor(params, img.device))
    return _bilinear(img, ys, xs)


def mse_metric(a, b, *, device=None):
    dev = device_of(a, b, device=device)
    return torch.mean((as_tensor(a, dev) - as_tensor(b, dev)) ** 2)


def mutual_information(a, b, n_bins: int = 32, sigma: float = 0.5, *,
                       device=None):
    """Differentiable MI by Parzen (gaussian) soft histograms."""
    dev = device_of(a, b, device=device)
    a = as_tensor(a, dev).reshape(-1)
    b = as_tensor(b, dev).reshape(-1)
    a = (a - a.min()) / torch.clamp_min(a.max() - a.min(), 1e-9)
    b = (b - b.min()) / torch.clamp_min(b.max() - b.min(), 1e-9)
    centers = torch.from_numpy(linspace32(0.0, 1.0, n_bins)).to(dev)
    bw = sigma / n_bins
    wa = torch.exp(-0.5 * ((a[:, None] - centers[None, :]) / bw) ** 2)
    wb = torch.exp(-0.5 * ((b[:, None] - centers[None, :]) / bw) ** 2)
    wa = wa / torch.clamp_min(wa.sum(dim=1, keepdim=True), 1e-12)
    wb = wb / torch.clamp_min(wb.sum(dim=1, keepdim=True), 1e-12)
    with float32_products():
        pab = (wa.T @ wb) / a.shape[0]
    pa = pab.sum(dim=1)
    pb = pab.sum(dim=0)
    eps = 1e-12
    return torch.sum(pab * (torch.log(pab + eps)
                            - torch.log(pa[:, None] * pb[None, :] + eps)))


def _downsample2(img):
    """2x box downsample (crops odd edges)."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    v = img[:h, :w]
    return 0.25 * (v[::2, ::2] + v[1::2, ::2] + v[::2, 1::2]
                   + v[1::2, 1::2])


def _metric(metric: str):
    if metric == "mse":
        return mse_metric
    if metric in ("mi", "mutual_information"):
        return lambda f, w: -mutual_information(f, w)
    raise ValueError(f"unknown metric {metric!r}")


def _value_and_grad(loss, x):
    """(loss(x), d loss / dx) at x, by autograd on a detached copy."""
    with torch.enable_grad():
        p = x.detach().requires_grad_(True)
        val = loss(p)
        (g,) = torch.autograd.grad(val, p)
    return val.detach(), g


def _per_step(values, device) -> torch.Tensor:
    """Per-iteration float32 constants on the device (dividing by one of
    them divides exactly on every device)."""
    return torch.from_numpy(np.asarray(values, np.float32)).to(device)


def register_images(fixed, moving, *, metric: str = "mse",
                    method: str = "rigid", n_iterations: int = 200,
                    learning_rate: float = 0.05,
                    pyramid_levels: int = 1, optimizer: str = "gd",
                    device=None):
    """Gradient-descent registration. Returns (params, warped, history)
    as NumPy arrays and a list of floats.

    method: 'rigid' (ty, tx, theta) or 'affine' (and the scales).
    pyramid_levels > 1 registers coarse to fine, each level at half the
    resolution of the next, the translations doubling on the way up.
    optimizer: 'adam' (bias-corrected, lr ~0.5) or 'gd' (plain steps)."""
    dev = device_of(fixed, moving, device=device)
    fixed = as_tensor(fixed, dev)
    moving = as_tensor(moving, dev)
    score = _metric(metric)

    pyr = [(fixed, moving)]       # coarsest first, after the reversal
    for _ in range(max(pyramid_levels, 1) - 1):
        f, m = pyr[-1]
        if min(f.shape) < 32:
            break
        pyr.append((_downsample2(f), _downsample2(m)))
    pyr = pyr[::-1]

    # per-parameter step scaling: translations in px, rotation in rad
    scale = torch.tensor([1.0, 1.0, 0.02, 0.0, 0.0], device=dev)
    if method == "affine":
        scale[3:] = 0.005
    params = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], device=dev)
    history = []
    iters = max(n_iterations // len(pyr), 1)
    bc1 = _per_step([1.0 - 0.9 ** (i + 1) for i in range(iters)], dev)
    bc2 = _per_step([1.0 - 0.999 ** (i + 1) for i in range(iters)], dev)
    for lvl, (f, m) in enumerate(pyr):
        if lvl > 0:  # translations double at each finer level
            params = params * torch.tensor([2.0, 2.0, 1.0, 1.0, 1.0],
                                           device=dev)

        def loss(p, f=f, m=m):
            return score(f, _bilinear(m, *_affine_grid(*m.shape, p)))

        mom = torch.zeros_like(params)
        vel = torch.zeros_like(params)
        for i in range(iters):
            val, g = _value_and_grad(loss, params)
            if optimizer == "adam":
                mom = 0.9 * mom + 0.1 * g
                vel = 0.999 * vel + 0.001 * g * g
                step = (mom / bc1[i]) / (torch.sqrt(vel / bc2[i]) + 1e-8)
            else:
                step = g
            params = params - learning_rate * scale * step
            history.append(val)
    hist = torch.stack(history).tolist() if history else []
    warped = warp_image(moving, params)
    return params.cpu().numpy(), warped.cpu().numpy(), hist


# ---------------------------------------------------------------------------
# Deformable (B-spline free-form) registration: a cubic B-spline control
# grid drives a dense displacement field, optimised by autograd.
# ---------------------------------------------------------------------------


def _bspline_weights(t):
    """Cubic B-spline basis at fractional offset t in [0,1): 4 weights."""
    t2, t3 = t * t, t * t * t
    return (
        divide(1 - 3 * t + 3 * t2 - t3, 6.0),
        divide(4 - 6 * t2 + 3 * t3, 6.0),
        divide(1 + 3 * t + 3 * t2 - 3 * t3, 6.0),
        divide(t3, 6.0),
    )


def bspline_displacement(control, shape, *, device=None):
    """Dense (2, H, W) displacement from a (2, cy, cx) control grid by
    separable cubic B-spline interpolation (the control points cover the
    image with one point of padding on each side)."""
    control = as_tensor(control, device)
    dev = control.device
    h, w = shape
    _, cy, cx = control.shape
    # control cell size so that interior control points span the image
    sy = (h - 1) / (cy - 3)
    sx = (w - 1) / (cx - 3)
    yy = divide(torch.arange(h, dtype=torch.float32, device=dev), sy)
    xx = divide(torch.arange(w, dtype=torch.float32, device=dev), sx)
    iy = torch.floor(yy).long()
    ix = torch.floor(xx).long()
    wy = _bspline_weights(yy - iy)             # 4 x (H,)
    wx = _bspline_weights(xx - ix)             # 4 x (W,)

    out = torch.zeros((2, h, w), dtype=torch.float32, device=dev)
    for a in range(4):
        rows = control.index_select(1, (iy + a).clamp(0, cy - 1))
        for b in range(4):
            cp = rows.index_select(2, (ix + b).clamp(0, cx - 1))
            out = out + cp * (wy[a][None, :, None] * wx[b][None, None, :])
    return out


def warp_deformable(image, control, *, device=None):
    """Warp by the B-spline displacement field (backward mapping)."""
    img = as_tensor(image, device)
    disp = bspline_displacement(as_tensor(control, img.device), img.shape)
    h, w = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    return _bilinear(img, yy - disp[0], xx - disp[1])


def deformable_loss(fixed, moving, control, *, smooth_weight: float = 0.01,
                    metric: str = "mse"):
    """register_deformable's objective: the metric of fixed against the
    warped moving image plus smooth_weight times the bending energy
    (mean squared second differences of the control grid)."""
    data = _metric(metric)(fixed, warp_deformable(moving, control))
    d2y = control[:, 2:, :] - 2 * control[:, 1:-1, :] + control[:, :-2, :]
    d2x = control[:, :, 2:] - 2 * control[:, :, 1:-1] + control[:, :, :-2]
    bend = torch.mean(d2y ** 2) + torch.mean(d2x ** 2)
    return data + smooth_weight * bend


def optax_bias_corrections(decay: float, n: int) -> list:
    """optax's Adam bias corrections 1 - decay ** count for counts 1..n,
    rounded as optax's jitted float32 power rounds them (NumPy's scalar
    float32 power; its vectorised power differs in the last bit)."""
    one, d = np.float32(1), np.float32(decay)
    return [one - d ** np.float32(k) for k in range(1, n + 1)]


def register_deformable(fixed, moving, *, grid_shape=(8, 8),
                        n_iterations: int = 300, learning_rate: float = 0.3,
                        smooth_weight: float = 0.01, metric: str = "mse",
                        device=None):
    """Free-form B-spline registration by Adam (optax's update) on the
    metric plus a bending-energy regulariser. Returns (control, warped,
    history); grid_shape counts interior control cells, the grid carries
    3 more points an axis."""
    dev = device_of(fixed, moving, device=device)
    fixed = as_tensor(fixed, dev)
    moving = as_tensor(moving, dev)
    _metric(metric)
    cy, cx = grid_shape[0] + 3, grid_shape[1] + 3

    def loss(control):
        return deformable_loss(fixed, moving, control,
                               smooth_weight=smooth_weight, metric=metric)

    b1, b2, eps = 0.9, 0.999, 1e-8
    bc1 = _per_step(optax_bias_corrections(b1, n_iterations), dev)
    bc2 = _per_step(optax_bias_corrections(b2, n_iterations), dev)
    control = torch.zeros((2, cy, cx), dtype=torch.float32, device=dev)
    mu = torch.zeros_like(control)
    nu = torch.zeros_like(control)
    history = []
    for k in range(n_iterations):
        val, g = _value_and_grad(loss, control)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        update = (mu / bc1[k]) / (torch.sqrt(nu / bc2[k]) + eps)
        control = control + -learning_rate * update
        history.append(val)
    hist = torch.stack(history).tolist() if history else []
    return (control.cpu().numpy(),
            warp_deformable(moving, control).cpu().numpy(), hist)
