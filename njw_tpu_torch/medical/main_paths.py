"""The medical-imaging paths at full width, defined once.

``chip_smoke.py`` phase 19 drives these on the card and
``scripts/profile_torch.py --model imaging`` profiles one call of each;
both take them from here. Each path has a setup (its inputs, made with
NumPy from fixed seeds and moved to the device, and any forward model)
and one or more timed calls. The phantoms, coil maps and test images are
NumPy copies of those of the JAX package's tests and examples:

  ct_suite_256      the suite's disk phantom 256^2, 180 angles: radon, then
                    filtered_backprojection (ramlak)
                    (njw_tpu/bench/suite.py:275-318)
  ct_fbp_512x360    the CT example's Shepp-Logan-like phantom at 512^2 (the
                    clinical matrix), 360 angles: radon, reconstruct_ct fbp
                    (examples/ct_reconstruction_example.py:27-103, --size
                    512 --angles 360)
  ct_sirt_256x180   the same phantom at 256^2, 180 angles, sirt 30
                    iterations (examples/ct_reconstruction_example.py:13-14)
  cone_fdk_128      the example's two-ball volume at 128^3, 90 views over
                    2 pi, sod 2 nz, sdd 4 nz, a 128^2 detector:
                    cone_beam_project, fdk_reconstruct
                    (examples/ct_reconstruction_example.py:130-149 at --size
                    512, nz = size // 4)
  mri_cg_256x8      the MRI example's phantom at 256^2, 8 coils, k-space
                    noise 0.002, R = 4 equispaced with an 8% centre:
                    MRIReconstructor("cg_sense", 15), primal-dual 80 (TV
                    0.02), FISTA 40 (lam 0.01) on the single-coil k-space
                    (examples/mri_reconstruction_example.py:56-110, --size
                    256 --coils 8 --accelerations 4)
  mri_radial_256    the tests' phantom at 256^2 sampled exactly on 201
                    radial spokes x 512 samples (102 912): KB gridding
                    (oversampling 2, width 4, Pipe-Menon 10 iterations)
                    beside bilinear gridding (njw_tpu/medical/mri.py:27:
                    M ~ 1e4-1e5; tests/test_medical.py:192-218's trajectory)
  filters_512       the tests' phantom at 512^2 plus noise 0.1: gaussian
                    sigma 2, median 5, bilateral 5, NLM (5, 1);
                    apply_filter("median") on a (64, 256, 256) volume
                    (tests/test_medical.py:240-285's filters, full size)
  seg_512           the tests' phantom at 512^2 (plus noise 0.3 where the
                    test adds it): otsu, adaptive, region_growing 256,
                    watershed 256 on two basins, chan_vese 100, mrf 20
                    (tests/test_medical.py:286-338's methods, full size)
  registration_256  the registration example's image at 256^2, warped by
                    (4, -3, 0.08) and a 4 x 4 B-spline bump of 1.5 px:
                    register_images (rigid, mse, Adam, lr 0.5, 3 levels, 300
                    iterations), then register_deformable (6 x 6, 150
                    iterations) on its output
                    (examples/image_registration_example.py:36-95, --size
                    256)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from njw_tpu_torch.medical import ct, filters, mri, registration
from njw_tpu_torch.medical import segmentation as seg


@dataclasses.dataclass(frozen=True)
class Call:
    """One timed call of a path: fn(inputs) -> output."""

    fn: Callable[[dict], Any]
    work: float            # units of the rate in one call
    unit: str              # the rate's unit
    graph: bool            # no host read or host copy: captures in a graph
    reps: int = 3          # timed calls, after one warm-up
    nan_ok: bool = False   # NaN is a value of the output (empty raster cells)
    # the call's device work alone, for a call that reads the host
    # (None: the call itself is captured, or profiled)
    device_fn: Optional[Callable[[dict], Any]] = None


@dataclasses.dataclass(frozen=True)
class ImagingPath:
    source: str
    setup: Callable[[torch.device], dict]
    calls: dict


# ---------------------------------------------------------------- inputs

def disk_phantom(n: int) -> np.ndarray:
    """The suite's centred disk of radius 0.4 n."""
    yy, xx = np.mgrid[0:n, 0:n]
    c = (n - 1) / 2
    return ((yy - c) ** 2 + (xx - c) ** 2 < (0.4 * n) ** 2).astype(
        np.float32)


def insert_phantom(n: int) -> np.ndarray:
    """The JAX tests' disk with an off-centre bright insert."""
    yy, xx = np.mgrid[0:n, 0:n]
    c = (n - 1) / 2
    img = ((yy - c) ** 2 + (xx - c) ** 2 < (0.4 * n) ** 2).astype(np.float32)
    img += ((yy - c - n * 0.12) ** 2 + (xx - c + n * 0.1) ** 2
            < (0.08 * n) ** 2).astype(np.float32)
    return img


def ct_shepp_logan(n: int) -> np.ndarray:
    """The CT example's Shepp-Logan-like phantom: nested ellipses."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    y = (yy - c) / c
    x = (xx - c) / c
    img = np.zeros((n, n), np.float32)
    for cy, cx, ry, rx, ang, val in [
        (0.0, 0.0, 0.92, 0.69, 0.0, 1.0),
        (0.0, 0.0, 0.874, 0.6624, 0.0, -0.8),
        (0.0, 0.22, 0.31, 0.11, -18.0, -0.2),
        (0.0, -0.22, 0.41, 0.16, 18.0, -0.2),
        (-0.35, 0.0, 0.25, 0.21, 0.0, 0.3),
        (-0.1, 0.0, 0.046, 0.046, 0.0, 0.15),
        (0.605, -0.08, 0.046, 0.023, 0.0, 0.15),
        (0.605, 0.06, 0.023, 0.046, 0.0, 0.15),
    ]:
        th = np.deg2rad(ang)
        yr = (y - cy) * np.cos(th) + (x - cx) * np.sin(th)
        xr = -(y - cy) * np.sin(th) + (x - cx) * np.cos(th)
        img += val * ((yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0)
    return np.clip(img, 0.0, None)


def mri_shepp_logan(n: int) -> np.ndarray:
    """The MRI example's soft-tissue phantom."""
    yy, xx = (np.mgrid[0:n, 0:n] - n / 2) / (n / 2)
    img = np.zeros((n, n), np.float32)
    for cy, cx, ry, rx, ang, val in [
        (0.0, 0.0, 0.85, 0.65, 0.0, 1.0),
        (0.0, 0.0, 0.78, 0.58, 0.0, -0.6),
        (0.22, 0.18, 0.25, 0.12, 0.6, 0.4),
        (0.2, -0.2, 0.28, 0.14, -0.6, 0.35),
        (-0.35, 0.0, 0.18, 0.18, 0.0, 0.5),
        (-0.07, 0.0, 0.046, 0.023, 0.0, 0.6),
    ]:
        c, s = np.cos(ang), np.sin(ang)
        y0, x0 = yy - cy, xx - cx
        yr, xr = c * y0 + s * x0, -s * y0 + c * x0
        img += val * ((yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0)
    return np.clip(img, 0, None)


def coil_maps(n: int, n_coils: int) -> np.ndarray:
    """The MRI example's gaussian coil sensitivities, normalised."""
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
    centers = [(0, 0), (0, 1), (1, 0), (1, 1),
               (0.5, 0), (0.5, 1), (0, 0.5), (1, 0.5)][:n_coils]
    sens = np.stack([np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.4)
                     for cy, cx in centers]).astype(np.complex64)
    return sens / np.sqrt((np.abs(sens) ** 2).sum(0, keepdims=True))


def registration_image(n: int) -> np.ndarray:
    """The registration example's textured test image."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    img = (np.sin(x / 7) * np.cos(y / 9)
           + np.exp(-((x - n * 0.5) ** 2 + (y - n * 0.42) ** 2) / (n * 3.2))
           + 0.5 * np.exp(-((x - n * 0.25) ** 2 + (y - n * 0.7) ** 2)
                          / (n * 1.5)))
    return img.astype(np.float32)


def ball_volume(nz: int) -> np.ndarray:
    """The cone-beam example's ball with a smaller ball inside."""
    zz, yy, xx = np.mgrid[0:nz, 0:nz, 0:nz].astype(np.float32)
    c = (nz - 1) / 2
    vol = (((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
           < (0.4 * nz) ** 2).astype(np.float32)
    vol += (((zz - c) ** 2 + (yy - c - nz * 0.15) ** 2 + (xx - c) ** 2)
            < (0.1 * nz) ** 2)
    return vol


def radial_trajectory(n_spokes: int, n_read: int) -> np.ndarray:
    """(M, 2) radial k-space coords (ky, kx) in [-0.5, 0.5): the JAX
    radial test's trajectory."""
    ang = np.pi * np.arange(n_spokes) / n_spokes
    rad = (np.arange(n_read) - n_read / 2) / n_read
    ky = (rad[None, :] * np.sin(ang[:, None])).ravel()
    kx = (rad[None, :] * np.cos(ang[:, None])).ravel()
    return np.stack([ky, kx], 1).astype(np.float32)


def exact_radial_samples(img: torch.Tensor, coords: torch.Tensor):
    """The image's DFT at each radial point (phases relative to the
    centre, over n), in complex128 by separable products: e_y^T img e_x."""
    n = img.shape[-1]
    k = torch.arange(n, dtype=torch.float64, device=img.device) - n // 2
    c = coords.to(torch.float64)
    ey = torch.exp(-2j * np.pi * c[:, 0:1] * k[None, :])      # (M, n)
    ex = torch.exp(-2j * np.pi * c[:, 1:2] * k[None, :])
    t = ex @ img.to(torch.complex128).T                       # (M, n_y)
    return ((ey * t).sum(1) / n).to(torch.complex64)


def _on(device, **arrays) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _angles(n_angles: int, span: float = np.pi) -> np.ndarray:
    return np.linspace(0, span, n_angles, endpoint=False).astype(np.float32)


# ---------------------------------------------------------------- setups

def _ct_setup(phantom, n: int, n_angles: int):
    def setup(device):
        d = _on(device, img=phantom(n), angles=_angles(n_angles))
        d["sino"] = ct.radon(d["img"], d["angles"])
        return d
    return setup


CONE = {"nz": 128, "views": 90}


def _cone_setup(device):
    nz = CONE["nz"]
    d = _on(device, vol=ball_volume(nz),
            angles=_angles(CONE["views"], 2 * np.pi))
    d.update(sod=2.0 * nz, sdd=4.0 * nz)
    d["proj"] = _cone_project(d)
    return d


def _cone_project(d):
    nz = CONE["nz"]
    return ct.cone_beam_project(d["vol"], d["angles"], sod=d["sod"],
                                sdd=d["sdd"], det_shape=(nz, nz))


def _cone_fdk(d):
    return ct.fdk_reconstruct(d["proj"], d["angles"], sod=d["sod"],
                              sdd=d["sdd"], output_size=CONE["nz"])


MRI = {"n": 256, "coils": 8, "r": 4, "noise": 0.002}


def _mri_setup(device):
    n = MRI["n"]
    img = mri_shepp_logan(n)
    sens = coil_maps(n, MRI["coils"])
    rng = np.random.default_rng(0)
    k_full = np.fft.fftshift(np.fft.fft2(sens * img[None], norm="ortho"),
                             axes=(-2, -1))
    k_full = k_full + MRI["noise"] * np.abs(k_full).max() * (
        rng.standard_normal(k_full.shape)
        + 1j * rng.standard_normal(k_full.shape))
    recon = mri.MRIReconstructor("cg_sense", 15, MRI["r"], device=device)
    mask = recon.undersampling_mask(n, n).cpu().numpy()
    k1 = mask * np.fft.fftshift(np.fft.fft2(img.astype(np.complex64),
                                            norm="ortho"))
    return _on(device, img=img, sens=sens, mask=mask,
               ku=(mask[None] * k_full).astype(np.complex64),
               k1=k1.astype(np.complex64))


def _cg_sense(d):
    r = mri.MRIReconstructor("cg_sense", 15, MRI["r"], d["sens"],
                             device=d["ku"].device)
    return r.process(d["ku"], d["mask"])


RADIAL = {"n": 256, "spokes": 201, "read": 512}


def _radial_setup(device):
    n = RADIAL["n"]
    d = _on(device, img=insert_phantom(n),
            coords=radial_trajectory(RADIAL["spokes"], RADIAL["read"]))
    d["samples"] = exact_radial_samples(d["img"], d["coords"])
    c = d["coords"].to(torch.float64)
    # grid_noncartesian's corner-phase convention
    d["corner"] = (d["samples"].to(torch.complex128) * torch.exp(
        -2j * np.pi * (n // 2) * (c[:, 0] + c[:, 1]))).to(torch.complex64)
    return d


def _filters_setup(device):
    rng = np.random.default_rng(0)
    noisy = insert_phantom(512) + 0.1 * rng.standard_normal(
        (512, 512)).astype(np.float32)
    vol = insert_phantom(256)[None] + 0.1 * rng.standard_normal(
        (64, 256, 256)).astype(np.float32)
    return _on(device, img=noisy, vol=vol)


SEG_N = 512


def two_basins(n: int) -> tuple:
    """The watershed test's two paraboloid basins and their markers."""
    yy, xx = np.mgrid[0:n, 0:n]
    a, b, m = n // 4, 3 * n // 4, n // 2
    elev = np.minimum((xx - a) ** 2 + (yy - m) ** 2,
                      (xx - b) ** 2 + (yy - m) ** 2).astype(np.float32)
    markers = np.zeros((n, n), np.int32)
    markers[m, a] = 1
    markers[m, b] = 2
    return elev, markers


def _seg_setup(device):
    rng = np.random.default_rng(3)
    clean = insert_phantom(SEG_N)
    noisy = clean + 0.3 * rng.standard_normal(
        (SEG_N, SEG_N)).astype(np.float32)
    elev, markers = two_basins(SEG_N)
    return _on(device, clean=clean, noisy=noisy, elev=elev, markers=markers)


REG = {"n": 256, "true": (4.0, -3.0, 0.08, 1.0, 1.0), "bump": 1.5}


def _registration_setup(device):
    n = REG["n"]
    fixed = torch.from_numpy(registration_image(n)).to(device)
    moving = registration.warp_image(fixed, torch.tensor(REG["true"],
                                                         device=device))
    ctrl = (REG["bump"] * np.random.default_rng(0).standard_normal(
        (2, 4, 4))).astype(np.float32)
    moving = registration.warp_deformable(moving,
                                          torch.from_numpy(ctrl).to(device))
    d = {"fixed": fixed, "moving": moving}
    params, warped, hist = _rigid(d)
    d.update(rigid_params=params, rigid_warped=torch.from_numpy(warped).to(
        device))
    return d


def _rigid(d):
    return registration.register_images(
        d["fixed"], d["moving"], metric="mse", method="rigid",
        n_iterations=300, pyramid_levels=3, optimizer="adam",
        learning_rate=0.5)


def _deformable(d):
    return registration.register_deformable(
        d["fixed"], d["rigid_warped"], grid_shape=(6, 6), n_iterations=150)


def _px(n: int, k: int = 1) -> int:
    return n * n * k


IMAGING_PATHS = {
    "ct_suite_256": ImagingPath(
        "njw_tpu/bench/suite.py:275-318", _ct_setup(disk_phantom, 256, 180),
        {"radon": Call(lambda d: ct.radon(d["img"], d["angles"]),
                       _px(256, 180), "px-angles/s", True),
         "fbp": Call(lambda d: ct.filtered_backprojection(d["sino"],
                                                          d["angles"]),
                     _px(256, 180), "px-angles/s", True)}),
    "ct_fbp_512x360": ImagingPath(
        "examples/ct_reconstruction_example.py:27-103 --size 512 "
        "--angles 360", _ct_setup(ct_shepp_logan, 512, 360),
        {"radon": Call(lambda d: ct.radon(d["img"], d["angles"]),
                       _px(512, 360), "px-angles/s", True),
         "fbp": Call(lambda d: ct.filtered_backprojection(d["sino"],
                                                          d["angles"]),
                     _px(512, 360), "px-angles/s", True)}),
    "ct_sirt_256x180": ImagingPath(
        "examples/ct_reconstruction_example.py:13-14",
        _ct_setup(ct_shepp_logan, 256, 180),
        {"sirt_30": Call(lambda d: ct.sirt(d["sino"], d["angles"],
                                           n_iterations=30),
                         _px(256, 180 * 30), "px-angles/s", True, reps=2)}),
    "cone_fdk_128": ImagingPath(
        "examples/ct_reconstruction_example.py:130-149 --size 512",
        _cone_setup,
        {"project": Call(_cone_project, 128 ** 3 * 90, "voxel-views/s",
                         False, reps=2),
         "fdk": Call(_cone_fdk, 128 ** 3 * 90, "voxel-views/s", True,
                     reps=2)}),
    "mri_cg_256x8": ImagingPath(
        "examples/mri_reconstruction_example.py:56-110 --size 256 "
        "--coils 8 --accelerations 4", _mri_setup,
        {"cg_sense_15": Call(_cg_sense, _px(256, 15), "px-iterations/s",
                             True),
         "primal_dual_80": Call(
             lambda d: mri.reconstruct_primal_dual(
                 d["k1"], d["mask"], num_iterations=80, tv_weight=0.02),
             _px(256, 80), "px-iterations/s", True),
         "fista_40": Call(
             lambda d: mri.reconstruct_compressed_sensing(
                 d["k1"], d["mask"], num_iterations=40, lam=0.01),
             _px(256, 40), "px-iterations/s", True)}),
    "mri_radial_256": ImagingPath(
        "njw_tpu/medical/mri.py:27 (M ~ 1e4-1e5); "
        "tests/test_medical.py:192-218", _radial_setup,
        {"kb_gridding": Call(
            lambda d: mri.gridding_reconstruct(d["samples"], d["coords"],
                                               RADIAL["n"]),
            RADIAL["spokes"] * RADIAL["read"], "samples/s", False),
         "bilinear": Call(
             lambda d: mri.grid_noncartesian(d["corner"], d["coords"],
                                             RADIAL["n"]),
             RADIAL["spokes"] * RADIAL["read"], "samples/s", False)}),
    "filters_512": ImagingPath(
        "tests/test_medical.py:240-285 at full size", _filters_setup,
        {"gaussian_2": Call(lambda d: filters.gaussian_filter(d["img"], 2.0),
                            _px(512), "px/s", True),
         "median_5": Call(lambda d: filters.median_filter(d["img"], 5),
                          _px(512), "px/s", True),
         "bilateral_5": Call(lambda d: filters.bilateral_filter(d["img"], 5),
                             _px(512), "px/s", True),
         "nlm_5_1": Call(lambda d: filters.nlm_filter(d["img"], 5, 1),
                         _px(512), "px/s", True),
         "median_volume_64x256": Call(
             lambda d: filters.apply_filter(d["vol"], "median"),
             _px(256, 64), "px/s", True)}),
    "seg_512": ImagingPath(
        "tests/test_medical.py:286-338 at full size", _seg_setup,
        {"otsu": Call(lambda d: seg.apply_segmentation(d["noisy"], "otsu"),
                      _px(SEG_N), "px-iterations/s", False),
         "adaptive": Call(
             lambda d: seg.apply_segmentation(d["noisy"], "adaptive"),
             _px(SEG_N), "px-iterations/s", True),
         "region_growing_256": Call(
             lambda d: seg.region_growing(d["clean"], (SEG_N // 2,
                                                       SEG_N // 2),
                                          tolerance=0.5, n_iterations=256),
             _px(SEG_N, 256), "px-iterations/s", True),
         "watershed_256": Call(
             lambda d: seg.watershed(d["elev"], d["markers"],
                                     n_iterations=256),
             _px(SEG_N, 256), "px-iterations/s", True),
         "chan_vese_100": Call(lambda d: seg.chan_vese(d["clean"], 100),
                               _px(SEG_N, 100), "px-iterations/s", True),
         "mrf_20": Call(lambda d: seg.mrf_segment(d["noisy"], 0.5, beta=0.3,
                                                  n_iterations=20),
                        _px(SEG_N, 20), "px-iterations/s", True)}),
    "registration_256": ImagingPath(
        "examples/image_registration_example.py:36-95 --size 256",
        _registration_setup,
        {"rigid_adam_300": Call(_rigid, _px(256, 300), "px-iterations/s",
                                False, reps=1),
         "deformable_150": Call(_deformable, _px(256, 150),
                                "px-iterations/s", False, reps=1)}),
}

