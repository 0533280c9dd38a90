"""DEM processing: terrain derivatives, viewshed, fast-sweeping sink
filling and cost distance, D8 flow, resampling, statistics.

Counterpart of ``njw_tpu/geospatial/dem.py``. The fast sweeps resolve a
whole line of the grid at a time: the min-plus relaxation by
``torch.cumsum`` and ``torch.cummin``, the fill recurrence by an
associative scan of its composed update maps (``associative_scan``: the
odd/even recursion of ``jax.lax.associative_scan``, so its sums round as
JAX's do), the diagonals as columns after a shear (pad and reshape). The
sweep cycles run to their fixed point by a host loop that reads max |Δ|
once a cycle; flow accumulation's push rounds read whether any mass still
moves once every ``PUSH_CHECK`` rounds (the rounds past the last move add
zeros, so the result is bit-identical to a check every round).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from njw_tpu_torch.platform.tensors import (
    as_tensor, divide, linspace32, to_numpy,
)

PUSH_CHECK = 16     # push rounds between host reads of "mass moves"


@dataclass(frozen=True)
class GeoTransform:
    """GDAL-style affine transform: geo = origin + pixel * size (+
    rotation terms)."""

    origin_x: float = 0.0
    origin_y: float = 0.0
    pixel_width: float = 1.0
    pixel_height: float = -1.0
    rotation_x: float = 0.0
    rotation_y: float = 0.0

    def pixel_to_geo(self, row, col):
        x = self.origin_x + col * self.pixel_width + row * self.rotation_x
        y = self.origin_y + col * self.rotation_y + row * self.pixel_height
        return x, y

    def geo_to_pixel(self, x, y):
        a, b = self.pixel_width, self.rotation_x
        c, d = self.rotation_y, self.pixel_height
        det = a * d - b * c
        dx, dy = x - self.origin_x, y - self.origin_y
        col = (d * dx - b * dy) / det
        row = (-c * dx + a * dy) / det
        return row, col


def _pad_edge(z, r: int = 1):
    return F.pad(z[None, None], (r, r, r, r), mode="replicate")[0, 0]


def terrain_derivatives(dem, cell_size: float = 1.0, *, device=None):
    """Slope (radians), aspect (radians) and curvature (5-point
    Laplacian) by Horn's stencil, edge-clamped."""
    z = as_tensor(dem, device)
    pad = _pad_edge(z)
    h, w = z.shape

    def sh(dy, dx):
        return pad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    dzdx = divide((sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
                  - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)),
                  8.0 * cell_size)
    dzdy = divide((sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
                  - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)),
                  8.0 * cell_size)
    slope = torch.atan(torch.sqrt(dzdx ** 2 + dzdy ** 2))
    aspect = torch.atan2(-dzdy, dzdx)
    curv = divide(sh(0, 1) + sh(0, -1) + sh(1, 0) + sh(-1, 0) - 4.0 * z,
                  cell_size * cell_size)
    return {"slope": slope, "aspect": aspect, "curvature": curv}


def viewshed(dem, observer_yx, observer_height: float = 1.8,
             cell_size: float = 1.0, n_samples: int = 128, *, device=None):
    """Boolean visibility from an observer cell by a polar radial sweep:
    one ray a perimeter cell (R rays, a multiple of 128), the running
    maximum elevation angle along each ray an exclusive cummax, and a cell
    visible when its own angle clears the cummax at its (ray, radius) bin.
    n_samples is kept for the signature (the sweep samples every cell
    width along each ray)."""
    z = as_tensor(dem, device)
    dev = z.device
    h, w = z.shape
    oy, ox = observer_yx
    zo = z[oy, ox] + observer_height

    L = int(np.ceil(np.hypot(h, w)))            # max radius (cells)
    R = int(-(-2 * (h + w) // 128) * 128)       # rays
    theta = (2.0 * np.pi / R) * torch.arange(R, dtype=torch.float32,
                                             device=dev)
    r = torch.arange(1, L + 1, dtype=torch.float32, device=dev)
    sy = oy + r[None, :] * torch.sin(theta)[:, None]      # (R, L)
    sx = ox + r[None, :] * torch.cos(theta)[:, None]
    iy = torch.round(sy).long().clamp(0, h - 1)
    ix = torch.round(sx).long().clamp(0, w - 1)
    inside = ((sy >= -0.5) & (sy <= h - 0.5)
              & (sx >= -0.5) & (sx <= w - 0.5))
    z_s = torch.where(inside, z.reshape(-1)[iy * w + ix], -math.inf)
    tan_a = (z_s - zo) / r[None, :]
    # exclusive running max: blockers strictly closer than each radius
    bm = torch.cummax(torch.cat(
        [torch.full((R, 1), -math.inf, device=dev), tan_a[:, :-1]], dim=1),
        dim=1).values

    # every grid cell's (ray, radius) bin
    dy = (torch.arange(h, device=dev) - oy).to(torch.float32)[:, None]
    dx = (torch.arange(w, device=dev) - ox).to(torch.float32)[None, :]
    dist = torch.sqrt(dy * dy + dx * dx)
    ang = torch.atan2(dy.expand(h, w), dx.expand(h, w))
    j = torch.remainder(torch.round(ang * (R / (2.0 * np.pi))).long(), R)
    k = (torch.round(dist).long() - 1).clamp(0, L - 1)
    tan_cell = (z - zo) / torch.clamp_min(dist, 0.5)
    blocked = bm.reshape(-1)[j * L + k] > tan_cell + 1e-6
    vis = ~blocked
    vis[oy, ox].fill_(True)        # a fill kernel: no copy from the host
    return vis


# ---------------------------------------------------------------------------
# Fast-sweeping building blocks: each directed line sweep resolves a whole
# line in one scan; diagonal directions are column scans after a shear.
# A cycle is 8 directed sweeps; cycles repeat to the fixed point of the
# one-cell relaxation.
# ---------------------------------------------------------------------------

_BIG = 1e30


def _shear(a, pad_value):
    """out[i, i+j] = a[i, j]: anti-diagonals (i+j const) become columns."""
    h, w = a.shape
    p = F.pad(a, (0, h), value=pad_value)
    return p.reshape(-1)[: h * (w + h - 1)].reshape(h, w + h - 1)


def _unshear(x, h, w):
    """Inverse of _shear: a[i, j] = x[i, i+j]."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, h * (w + h) - flat.numel()))
    return flat.reshape(h, w + h)[:, :w]


def _slice(x, start, stop=None, step=1):
    return x[..., slice(start, stop, step)]


def _interleave(even, odd):
    """even at the even places of the last axis, odd at the odd ones."""
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def associative_scan(fn, elems):
    """Inclusive scan of ``fn`` (associative, fn(earlier, later)) along
    the last axis of each tensor in the tuple ``elems``: JAX's
    ``lax.associative_scan`` recursion (combine adjacent pairs, scan the
    half, fill in the evens), so every combination happens in JAX's
    order. log2(n) levels of whole-array operations."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = fn(tuple(_slice(e, 0, -1, 2) for e in elems),
                 tuple(_slice(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(_slice(e, 0, -1) for e in odd),
                  tuple(_slice(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(_slice(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_slice(e, 0, 1), r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _minplus_sweep(d, e):
    """Exact shortest-path line relaxation along the last axis, both
    directions (the backward pass sees the forward result). e[..., j] is
    the edge cost between cells j-1 and j (e[..., 0] = 0): min over
    j' <= j of d[j'] + sum(e[j'+1..j]) is C[j] + cummin(d - C)[j] with
    C = cumsum(e)."""
    C = torch.cumsum(e, dim=-1)
    d = torch.minimum(d, C + torch.cummin(d - C, dim=-1).values)
    er = torch.cat([torch.zeros_like(e[..., :1]),
                    torch.flip(e, (-1,))[..., :-1]], dim=-1)
    df = torch.flip(d, (-1,))
    Cr = torch.cumsum(er, dim=-1)
    df = torch.minimum(df, Cr + torch.cummin(df - Cr, dim=-1).values)
    return torch.flip(df, (-1,))


def _compose(left, right):
    """The fill update f(h) = min(a, max(b, h + m)) after another:
    (A, B, M) = (min(a2, max(b2, a1 + m2)), max(b2, b1 + m2), m1 + m2)."""
    a1, b1, m1 = left
    a2, b2, m2 = right
    return (torch.minimum(a2, torch.maximum(b2, a1 + m2)),
            torch.maximum(b2, b1 + m2), m1 + m2)


def _fill_sweep(wv, z, eps):
    """One line solve of W = min(W, max(z, W_prev + eps)) along the last
    axis, both directions, by one associative scan each."""
    m = torch.full_like(wv, eps)
    # the prefix map applied to h0 = +BIG is A (A <= a <= BIG)
    wv = associative_scan(_compose, (wv, z, m))[0]
    wf = torch.flip(wv, (-1,))
    zf = torch.flip(z, (-1,))
    wf = associative_scan(_compose, (wf, zf, m))[0]
    return torch.flip(wf, (-1,))


def _converge(cycle, x, n_max: int, tol: float):
    """Repeat ``cycle`` until max |Δ| <= tol or n_max cycles (one host
    read a cycle; the test in float32, as JAX's)."""
    tol32 = float(np.float32(tol))
    for _ in range(n_max):
        x2 = cycle(x)
        delta = float(torch.max(torch.abs(x2 - x)))
        x = x2
        if delta <= tol32:
            break
    return x


def _t(a):
    return a.T.contiguous()


def fill_sinks(dem, n_iterations: int = 64, epsilon: float = 1e-3, *,
               device=None):
    """Depression filling: W from +BIG but at the boundary, relaxed to the
    least fixed point of W = max(z, min(W, min_8neighbour(W) + eps)) by
    fast-sweeping line solves; n_iterations bounds the 8-direction
    cycles."""
    z = as_tensor(dem, device)
    h, w = z.shape
    w0 = torch.full_like(z, _BIG)
    w0[0, :] = z[0, :]
    w0[-1, :] = z[-1, :]
    w0[:, 0] = z[:, 0]
    w0[:, -1] = z[:, -1]
    zt = _t(z)
    zs1 = _t(_shear(z, -_BIG))
    zs2 = _t(_shear(torch.flip(z, (1,)), -_BIG))

    def cycle(wv):
        wv = torch.maximum(z, _fill_sweep(wv, z, epsilon))             # E, W
        wv = torch.maximum(z, _fill_sweep(_t(wv), zt, epsilon).T)      # S, N
        ws = _fill_sweep(_t(_shear(wv, _BIG)), zs1, epsilon).T   # SW, NE
        wv = torch.maximum(z, _unshear(ws, h, w))
        ws = _fill_sweep(_t(_shear(torch.flip(wv, (1,)), _BIG)), zs2,
                         epsilon).T                                   # SE, NW
        return torch.maximum(z, torch.flip(_unshear(ws, h, w), (1,)))

    return _converge(cycle, w0, n_iterations, epsilon * 0.25)


_D8_OFFSETS = np.asarray(
    [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)],
    np.int32)


def flow_direction(dem, *, device=None):
    """D8 flow direction: index 0..7 of the steepest-descent neighbour
    (the first of equal drops), -1 for pits; int32."""
    z = as_tensor(dem, device)
    h, w = z.shape
    pad = _pad_edge(z)
    best = torch.zeros((h, w), dtype=torch.int32, device=z.device)
    top = None
    for i, (dy, dx) in enumerate(_D8_OFFSETS.tolist()):
        nb = pad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        drop = divide(z - nb, float(np.hypot(dy, dx)))
        if top is None:
            top = drop
            continue
        higher = drop > top
        top = torch.where(higher, drop, top)
        best = torch.where(higher, i, best)
    return torch.where(top > 0, best, -1).to(torch.int32)


def _flow_accumulation_doubling(z, n_iterations: int):
    h, w = z.shape
    n = h * w
    dev = z.device
    fdir = flow_direction(z).long()
    offs = torch.from_numpy(_D8_OFFSETS.astype(np.int64)).to(dev)
    d = offs[fdir.clamp(0, 7)]
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    ty, tx = yy + d[..., 0], xx + d[..., 1]
    valid = (fdir >= 0) & (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    # pits and off-grid flows drain into a dead slot at index n
    ptr = torch.where(valid, ty * w + tx, n).reshape(-1)
    max_len = n if n_iterations <= 0 else min(n_iterations, n)
    rounds = max(int(np.ceil(np.log2(max(max_len, 2)))), 1)
    acc = torch.ones(n + 1, dtype=torch.float32, device=dev)
    acc[n].fill_(0.0)
    dead = torch.full((1,), n, dtype=ptr.dtype, device=dev)
    for _ in range(rounds):
        # every pointer chain has ended once all point at the dead slot
        if not bool(torch.any(ptr != n)):
            break
        sums = torch.zeros(n + 1, dtype=torch.float32,
                           device=dev).index_add_(0, ptr, acc[:n])
        acc = acc + sums
        ptr = torch.cat([ptr, dead])[ptr]
    return acc[:n].reshape(h, w)


def _shift_to(f, dy: int, dx: int):
    """Mass at (y, x) lands at (y + dy, x + dx); off-grid mass drains
    away (zero fill)."""
    h, w = f.shape
    p = F.pad(f, (1, 1, 1, 1))
    return p[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def _flow_accumulation_push(z, n_iterations: int):
    h, w = z.shape
    fdir = flow_direction(z)
    valid = fdir >= 0
    max_rounds = h * w if n_iterations <= 0 else int(n_iterations)
    masks = [fdir == d for d in range(8)]
    acc = torch.ones((h, w), dtype=torch.float32, device=z.device)
    mov = torch.where(valid, 1.0, 0.0)
    done = 0
    while done < max_rounds:
        if not bool(torch.any(mov > 0)):
            break
        for _ in range(min(PUSH_CHECK, max_rounds - done)):
            pushed = torch.zeros_like(acc)
            for d, (dy, dx) in enumerate(_D8_OFFSETS.tolist()):
                pushed = pushed + _shift_to(
                    torch.where(masks[d], mov, 0.0), dy, dx)
            # mass landing on a pit stays (already counted in acc)
            acc = acc + pushed
            mov = torch.where(valid, pushed, 0.0)
            done += 1
    return acc


def flow_accumulation(dem, n_iterations: int = 0, method: str = "push", *,
                      device=None):
    """Cells drained through each cell, itself included, over the D8
    forest. method 'push': every cell's moving mass advances one hop a
    round by 8 masked shifts until none moves; 'doubling': the series
    sum_k (F^T)^k 1 by pointer doubling (scatter-add along the pointers,
    then ptr <- ptr[ptr]). Both exact (integer counts in float32) and
    equal; n_iterations optionally caps the path length resolved."""
    z = as_tensor(dem, device)
    if method == "push":
        return _flow_accumulation_push(z, n_iterations)
    return _flow_accumulation_doubling(z, n_iterations)


def _edges(cc):
    return torch.cat([torch.zeros_like(cc[..., :1]),
                      0.5 * (cc[..., :-1] + cc[..., 1:])], dim=-1)


def cost_distance(cost, source_yx, n_iterations: int = 64, *, device=None):
    """Accumulated-cost surface from a source over the 8-neighbourhood,
    edge cost hypot(dy, dx) * (c_from + c_to) / 2, by fast-sweeping
    min-plus line relaxations to the Bellman fixed point; n_iterations
    bounds the sweep cycles."""
    c = as_tensor(cost, device)
    h, w = c.shape
    d0 = torch.full_like(c, _BIG)
    d0[source_yx[0], source_yx[1]].fill_(0.0)
    r2 = float(np.sqrt(2.0))
    e_h = _edges(c)
    e_v = _edges(_t(c))
    # sheared cost pads are zero, so the cumulative sums stay real-sized
    # (pad cells carry d = BIG and never win a relaxation)
    e_d1 = r2 * _edges(_t(_shear(c, 0.0)))
    e_d2 = r2 * _edges(_t(_shear(torch.flip(c, (1,)), 0.0)))

    def cycle(d):
        d = _minplus_sweep(d, e_h)                                 # E, W
        d = _minplus_sweep(_t(d), e_v).T                           # S, N
        d = _unshear(_minplus_sweep(_t(_shear(d, _BIG)), e_d1).T, h, w)
        d = _unshear(_minplus_sweep(_t(_shear(torch.flip(d, (1,)), _BIG)),
                                    e_d2).T, h, w)
        return torch.clamp_max(torch.flip(d, (1,)), _BIG)

    return _converge(cycle, d0, n_iterations, 1e-5)


def least_cost_path(cost, source_yx, target_yx, n_iterations: int = 64, *,
                    device=None):
    """Backtrack the cost-distance surface from target to source: a list
    of (y, x) (a host walk)."""
    dist = to_numpy(cost_distance(cost, source_yx, n_iterations=n_iterations,
                                  device=device))
    h, w = dist.shape
    path = [tuple(target_yx)]
    cur = tuple(target_yx)
    for _ in range(h * w):
        if cur == tuple(source_yx):
            break
        cy, cx = cur
        best, best_d = cur, dist[cy, cx]
        for dy, dx in _D8_OFFSETS.tolist():
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < h and 0 <= nx < w and dist[ny, nx] < best_d:
                best, best_d = (ny, nx), dist[ny, nx]
        if best == cur:
            break  # stuck (unreachable)
        cur = best
        path.append(cur)
    return path[::-1]


def resample(dem, out_h: int, out_w: int, method: str = "bilinear", *,
             device=None):
    """Resample to an (out_h, out_w) grid spanning the same extent."""
    z = as_tensor(dem, device)
    h, w = z.shape
    ys = torch.from_numpy(linspace32(0.0, h - 1.0, out_h)).to(z.device)
    xs = torch.from_numpy(linspace32(0.0, w - 1.0, out_w)).to(z.device)
    if method == "nearest":
        yi = torch.round(ys).long()
        xi = torch.round(xs).long()
        return z[yi[:, None], xi[None, :]]
    y0 = torch.floor(ys).long().clamp(0, h - 2)
    x0 = torch.floor(xs).long().clamp(0, w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    Y0, X0 = y0[:, None], x0[None, :]
    return ((1 - fy) * (1 - fx) * z[Y0, X0]
            + (1 - fy) * fx * z[Y0, X0 + 1]
            + fy * (1 - fx) * z[Y0 + 1, X0]
            + fy * fx * z[Y0 + 1, X0 + 1])


def dem_statistics(dem, *, device=None) -> dict:
    """min, max, mean and std of the finite cells (float64) and the mean
    slope."""
    a = to_numpy(dem).astype(np.float64)
    finite = a[np.isfinite(a)]
    slope = terrain_derivatives(
        dem if isinstance(dem, torch.Tensor) else a.astype(np.float32),
        device=device)["slope"]
    return {
        "min": float(finite.min()), "max": float(finite.max()),
        "mean": float(finite.mean()), "std": float(finite.std()),
        "mean_slope": float(to_numpy(slope).mean()),
    }


class DEMProcessor:
    """The DEM operations bundled with a GeoTransform; the DEM lives on
    ``device`` (a tensor stays where it is)."""

    def __init__(self, dem, geo_transform: GeoTransform = GeoTransform(),
                 cell_size: float = 1.0, *, device="cuda"):
        self.dem = as_tensor(dem, device)
        self.geo_transform = geo_transform
        self.cell_size = cell_size

    def viewshed(self, observer_yx, observer_height: float = 1.8, **kw):
        return viewshed(self.dem, observer_yx, observer_height,
                        self.cell_size, **kw)

    def terrain_derivatives(self):
        return terrain_derivatives(self.dem, self.cell_size)

    def hydrology(self, n_iterations: int = 64):
        filled = fill_sinks(self.dem, n_iterations)
        return {
            "filled": filled,
            "flow_direction": flow_direction(filled),
            "flow_accumulation": flow_accumulation(filled, n_iterations),
        }

    def least_cost_path(self, source_yx, target_yx, cost=None, **kw):
        if cost is None:
            cost = 1.0 + terrain_derivatives(self.dem,
                                             self.cell_size)["slope"] * 10.0
        return least_cost_path(cost, source_yx, target_yx, **kw)

    def fill_sinks(self, **kw):
        return fill_sinks(self.dem, **kw)

    def statistics(self):
        return dem_statistics(self.dem)

    def resample(self, out_h: int, out_w: int, method: str = "bilinear"):
        return resample(self.dem, out_h, out_w, method)
