"""CT reconstruction: Radon transform, filtered backprojection, SIRT,
cone-beam projection and FDK.

Counterpart of ``njw_tpu/medical/ct.py``. The JAX package vmaps over
angles; here every angle is a leading batch dimension of one set of
tensor operations: bilinear and trilinear samples are gathers on int64
flat indices (clamped, zero outside), the ramp filter one batched
``rfft`` / ``irfft`` pair over all projections. Parallel-beam geometry:
an (N, N) image rotating about its centre, N unit detector bins, angles
in radians. Cone-beam: an (N, N, N) volume as (z, y, x) rotating about
z, a flat (nv, nu) detector at ``sdd`` from the source, orbit radius
``sod``; the projection and the FDK backprojection go over chunks of
views where the (views, N^3) temporaries would be large.
"""
from __future__ import annotations

import math

import torch

from njw_tpu_torch.platform.tensors import as_tensor, linspace32, rdivide

# elements of one (views, ...) temporary above which the cone-beam paths
# go over chunks of views: 2^26 float32 values are 256 MB
CHUNK_ELEMENTS = 1 << 26


def _take(flat, idx):
    """flat[..., idx] for a (B, M) source and a (B, ...) index."""
    b = flat.shape[0]
    return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(idx.shape)


def _bilinear(img, yy, xx):
    """Bilinear samples of an (h, w) image at float coords of any shape,
    or of a (B, h, w) stack at (B, ...) coords; zero outside."""
    h, w = img.shape[-2:]
    if img.ndim == 2:
        flat = img.reshape(-1)

        def take(idx):
            return flat[idx]
    else:
        flat = img.reshape(img.shape[0], h * w)

        def take(idx):
            return _take(flat, idx)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    dy = yy - y0
    dx = xx - x0
    y0 = y0.long()
    x0 = x0.long()

    def at(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = take(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        return torch.where(inside, v, 0.0)

    return ((1 - dy) * (1 - dx) * at(y0, x0)
            + (1 - dy) * dx * at(y0, x0 + 1)
            + dy * (1 - dx) * at(y0 + 1, x0)
            + dy * dx * at(y0 + 1, x0 + 1))


def _angles(angles, device):
    return as_tensor(angles, device).reshape(-1)


def radon(image, angles, n_detectors: int = 0, *, device=None):
    """Forward projection: sinogram (n_angles, n_detectors)."""
    image = as_tensor(image, device)
    th = _angles(angles, image.device)[:, None, None]
    n = image.shape[0]
    nd = n_detectors or n
    c = (n - 1) / 2.0
    dev = image.device
    t = torch.arange(nd, dtype=torch.float32, device=dev) - (nd - 1) / 2.0
    s = torch.arange(n, dtype=torch.float32, device=dev) - c
    ct, st = torch.cos(th), torch.sin(th)
    # ray: x = t*ct - s*st, y = t*st + s*ct (rotated grid)
    xx = t[:, None] * ct - s[None, :] * st + c
    yy = t[:, None] * st + s[None, :] * ct + c
    return torch.sum(_bilinear(image, yy, xx), dim=2)


def _ramp_filter(nd: int, kind: str = "ramlak", device="cpu"):
    """Frequency-domain ramp |f| on the zero-padded length 2 nd, with an
    optional apodization window."""
    n = 2 * nd
    # rfftfreq(n) in float32, made on the device (no host copy)
    f = torch.arange(n // 2 + 1, dtype=torch.float32, device=device) \
        / torch.full((), n, dtype=torch.float32, device=device)
    ramp = 2.0 * f
    if kind == "ramlak":
        win = torch.ones_like(ramp)
    elif kind == "shepp_logan":
        x = f / torch.clamp_min(f[-1], 1e-9)
        win = torch.sinc(x / 2.0)
    elif kind == "cosine":
        win = torch.cos(math.pi * f / torch.clamp_min(2 * f[-1], 1e-9))
    elif kind == "hann":
        win = 0.5 * (1 + torch.cos(math.pi * f
                                   / torch.clamp_min(f[-1], 1e-9)))
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return ramp * win


def _ramp_filtered(rows, kind: str):
    """Each row (last axis, length nd) filtered by the ramp, zero-padded
    to 2 nd and cut back to nd."""
    nd = rows.shape[-1]
    H = _ramp_filter(nd, kind, rows.device)
    spec = torch.fft.rfft(rows, n=2 * nd, dim=-1)
    return torch.fft.irfft(spec * H, n=2 * nd, dim=-1)[..., :nd]


def _backproject(sino, angles, n: int):
    """Sum over angles of each projection's linear interpolation at every
    pixel's detector coordinate: (n, n)."""
    nd = sino.shape[-1]
    dev = sino.device
    c = (n - 1) / 2.0
    cd = (nd - 1) / 2.0
    ys = torch.arange(n, dtype=torch.float32, device=dev) - c
    xs = torch.arange(n, dtype=torch.float32, device=dev) - c
    th = angles[:, None, None]
    ct, st = torch.cos(th), torch.sin(th)
    t = xs[None, :] * ct + ys[:, None] * st + cd
    t0 = torch.floor(t).long()
    dt = t - t0
    inside = (t0 >= 0) & (t0 < nd - 1)
    p0 = _take(sino, t0.clamp(0, nd - 1))
    p1 = _take(sino, (t0 + 1).clamp(0, nd - 1))
    return torch.sum(torch.where(inside, (1 - dt) * p0 + dt * p1, 0.0),
                     dim=0)


def filtered_backprojection(sinogram, angles, output_size: int = 0,
                            filter_kind: str = "ramlak", *, device=None):
    """FBP: ramp-filter all projections in one batched rfft, then
    backproject every angle at once."""
    sino = as_tensor(sinogram, device)
    n_angles, nd = sino.shape
    n = output_size or nd
    filtered = _ramp_filtered(sino, filter_kind)
    acc = _backproject(filtered, _angles(angles, sino.device), n)
    return acc * (math.pi / (2.0 * n_angles))


def sirt(sinogram, angles, n_iterations: int = 20, output_size: int = 0,
         relaxation: float = 1.0, *, device=None):
    """SIRT: x <- x + lam * C A^T R (b - A x), C = 1 / colsum,
    R = 1 / rowsum. A fixed count of iterations with no host read."""
    sino = as_tensor(sinogram, device)
    n_angles, nd = sino.shape
    n = output_size or nd
    ang = _angles(angles, sino.device)
    ones_img = torch.ones((n, n), dtype=torch.float32, device=sino.device)
    row_sums = radon(ones_img, ang, n_detectors=nd)           # A 1
    col_sums = _backproject(torch.ones_like(sino), ang, n)     # A^T 1
    row_den = torch.clamp_min(row_sums, 1e-6)
    col_den = torch.clamp_min(col_sums, 1e-6)
    x = torch.zeros((n, n), dtype=torch.float32, device=sino.device)
    for _ in range(n_iterations):
        resid = (sino - radon(x, ang, n_detectors=nd)) / row_den
        corr = _backproject(resid, ang, n)
        x = x + relaxation * corr / col_den
    return x


def _trilinear(vol, zz, yy, xx):
    """Trilinear samples of an (nz, ny, nx) volume at float coords, zero
    outside."""
    nz, ny, nx = vol.shape
    flat = vol.reshape(-1)
    z0, y0, x0 = (torch.floor(c) for c in (zz, yy, xx))
    dz, dy, dx = zz - z0, yy - y0, xx - x0
    z0, y0, x0 = (c.long() for c in (z0, y0, x0))

    def at(zi, yi, xi):
        inside = ((zi >= 0) & (zi < nz) & (yi >= 0) & (yi < ny)
                  & (xi >= 0) & (xi < nx))
        idx = ((zi.clamp(0, nz - 1) * ny + yi.clamp(0, ny - 1)) * nx
               + xi.clamp(0, nx - 1))
        return torch.where(inside, flat[idx], 0.0)

    return ((1 - dz) * ((1 - dy) * ((1 - dx) * at(z0, y0, x0)
                                    + dx * at(z0, y0, x0 + 1))
                        + dy * ((1 - dx) * at(z0, y0 + 1, x0)
                                + dx * at(z0, y0 + 1, x0 + 1)))
            + dz * ((1 - dy) * ((1 - dx) * at(z0 + 1, y0, x0)
                                + dx * at(z0 + 1, y0, x0 + 1))
                    + dy * ((1 - dx) * at(z0 + 1, y0 + 1, x0)
                            + dx * at(z0 + 1, y0 + 1, x0 + 1))))


def _view_chunks(n_views: int, per_view: int) -> list:
    """[(start, stop)] of view chunks, each as many views as keep a
    (views, per_view) temporary under CHUNK_ELEMENTS."""
    step = max(1, CHUNK_ELEMENTS // max(per_view, 1))
    return [(a, min(a + step, n_views)) for a in range(0, n_views, step)]


def cone_beam_project(volume, angles, *, sod: float, sdd: float,
                      det_shape=(64, 64), n_samples: int = 0, device=None):
    """(A, nv, nu) cone-beam projections of an (N, N, N) volume: each
    detector pixel's ray from the source sampled at n_samples points
    (1.5 N by default) and summed times the sample spacing. Views are
    independent, so chunking them changes no value."""
    vol = as_tensor(volume, device)
    dev = vol.device
    ang = _angles(angles, dev)
    n = vol.shape[-1]
    nv, nu = det_shape
    n_samples = n_samples or int(1.5 * n)
    c = (n - 1) / 2.0
    u = torch.arange(nu, dtype=torch.float32, device=dev) - (nu - 1) / 2.0
    v = torch.arange(nv, dtype=torch.float32, device=dev) - (nv - 1) / 2.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")       # (nv, nu)
    t = torch.from_numpy(linspace32(0.0, 1.0, n_samples)).to(dev)
    t = t[:, None, None]
    outs = []
    for a, b in _view_chunks(len(ang), n_samples * nv * nu):
        th = ang[a:b, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        src = (sod * ct, sod * st, torch.zeros_like(ct))
        # detector centre at (sod - sdd) along the source direction; its
        # u axis (-st, ct, 0), its v axis (0, 0, 1)
        det = ((sod - sdd) * ct + -st * uu, (sod - sdd) * st + ct * uu, vv)
        ray = [d - s for d, s in zip(det, src)]         # (V, nv, nu) each
        # world (x, y, z) -> voxel indices (z, y, x)
        xs, ys, zs = (s[:, None] + r[:, None] * t + c
                      for s, r in zip(src, ray))        # (V, T, nv, nu)
        samples = _trilinear(vol, zs, ys, xs)
        seg = torch.sqrt(ray[0] * ray[0] + ray[1] * ray[1]
                         + ray[2] * ray[2]) / (n_samples - 1)
        outs.append(torch.sum(samples, dim=1) * seg)
    return torch.cat(outs)


def fdk_reconstruct(projections, angles, *, sod: float, sdd: float,
                    output_size: int = 0, filter_kind: str = "ramlak",
                    device=None):
    """Feldkamp-Davis-Kress cone-beam reconstruction -> (N, N, N):
    cosine weighting, row-wise ramp filtering, distance-weighted
    backprojection summed over views, as many views at a time as keep a
    (views, N^3) temporary under CHUNK_ELEMENTS; the chunks' sums are
    added in turn, so past one chunk the order of the sum differs from
    one sum over all views."""
    g = as_tensor(projections, device)                  # (A, nv, nu)
    dev = g.device
    ang = _angles(angles, dev)
    na, nv, nu = g.shape
    n = output_size or nu
    u = torch.arange(nu, dtype=torch.float32, device=dev) - (nu - 1) / 2.0
    v = torch.arange(nv, dtype=torch.float32, device=dev) - (nv - 1) / 2.0

    # 1. cosine weighting
    w = rdivide(sdd, torch.sqrt(sdd ** 2 + u[None, :] ** 2
                                + v[:, None] ** 2))
    gw = g * w[None]
    # 2. row-wise ramp filtering along u
    gf = _ramp_filtered(gw, filter_kind)
    # 3. weighted backprojection
    c = (n - 1) / 2.0
    ax = torch.arange(n, dtype=torch.float32, device=dev)
    zz, yy, xx = (m - c for m in torch.meshgrid(ax, ax, ax, indexing="ij"))
    acc = None
    for a, b in _view_chunks(na, n ** 3):
        th = ang[a:b, None, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        U = sod - (xx * ct + yy * st)
        uu = sdd * (-xx * st + yy * ct) / U
        vv = sdd * zz / U
        val = _bilinear(gf[a:b], vv + (nv - 1) / 2.0, uu + (nu - 1) / 2.0)
        part = torch.sum(val * rdivide(sod, U) ** 2, dim=0)
        acc = part if acc is None else acc + part
    return acc * (math.pi / na)
