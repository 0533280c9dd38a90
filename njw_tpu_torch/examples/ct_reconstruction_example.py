"""CT reconstruction study: phantom -> (noisy) sinogram -> FBP and SIRT
across angle counts and noise levels, and an optional cone-beam FDK pass
on a 3-D phantom. Counterpart of ``examples/ct_reconstruction_example.py``.

The Radon transform and backprojection sample every ray of every angle
in one batched gather; SIRT iterates them on the device; FDK
backprojects every view of the 3-D volume.

    python -m njw_tpu_torch.examples.ct_reconstruction_example --size 256 \\
        --angles 90 180 --noise 0.0 0.02 --sirt-iterations 30 --json
"""
import argparse
import json
import os

import numpy as np

from njw_tpu_torch.examples._common import (
    add_device, can_draw, timed,
)
from njw_tpu_torch.medical import filtered_backprojection, radon, sirt
from njw_tpu_torch.medical.ct import cone_beam_project, fdk_reconstruct
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import to_numpy


def shepp_logan_like(n: int) -> np.ndarray:
    """Simplified Shepp-Logan-style phantom: nested ellipses with
    different attenuation (enough structure to expose streak artifacts)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    y = (yy - c) / c
    x = (xx - c) / c
    img = np.zeros((n, n), np.float32)
    # (cy, cx, ry, rx, angle_deg, value)
    ellipses = [
        (0.0, 0.0, 0.92, 0.69, 0.0, 1.0),
        (0.0, 0.0, 0.874, 0.6624, 0.0, -0.8),
        (0.0, 0.22, 0.31, 0.11, -18.0, -0.2),
        (0.0, -0.22, 0.41, 0.16, 18.0, -0.2),
        (-0.35, 0.0, 0.25, 0.21, 0.0, 0.3),
        (-0.1, 0.0, 0.046, 0.046, 0.0, 0.15),
        (0.605, -0.08, 0.046, 0.023, 0.0, 0.15),
        (0.605, 0.06, 0.023, 0.046, 0.0, 0.15),
    ]
    for cy, cx, ry, rx, ang, val in ellipses:
        th = np.deg2rad(ang)
        yr = (y - cy) * np.cos(th) + (x - cx) * np.sin(th)
        xr = -(y - cy) * np.sin(th) + (x - cx) * np.cos(th)
        img += val * ((yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0)
    return np.clip(img, 0.0, None)


def psnr(rec: np.ndarray, ref: np.ndarray) -> float:
    mse = float(np.mean((rec - ref) ** 2))
    peak = float(ref.max()) or 1.0
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.ct_reconstruction_example",
        description=__doc__)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--angles", type=int, nargs="+", default=[180],
                   help="projection counts to sweep")
    p.add_argument("--noise", type=float, nargs="+", default=[0.0],
                   help="gaussian sinogram noise sigmas (fraction of max)")
    p.add_argument("--sirt-iterations", type=int, default=30)
    p.add_argument("--filter", default="ramlak",
                   choices=["ramlak", "shepp_logan", "hann"],
                   help="FBP ramp apodization")
    p.add_argument("--cone-beam", action="store_true",
                   help="also run a 3-D cone-beam FDK study")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line with all metrics")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    draw = can_draw("ct_reconstruction_example")
    rng = np.random.default_rng(0)
    img = shepp_logan_like(args.size)
    rows = []

    for n_ang in args.angles:
        angles = np.linspace(0, np.pi, n_ang, endpoint=False)
        sino, t_fwd = timed(lambda: to_numpy(radon(img, angles, device=dev)),
                            dev)
        for sigma in args.noise:
            noisy = sino + sigma * sino.max() * rng.standard_normal(
                sino.shape).astype(np.float32)
            fbp, t_fbp = timed(lambda: to_numpy(filtered_backprojection(
                noisy, angles, filter_kind=args.filter, device=dev)), dev)
            it, t_sirt = timed(lambda: to_numpy(sirt(
                noisy, angles, n_iterations=args.sirt_iterations,
                device=dev)), dev)
            row = {
                "angles": n_ang, "noise": sigma,
                "radon_ms": round(t_fwd * 1e3, 2),
                "fbp_ms": round(t_fbp * 1e3, 2),
                "sirt_ms": round(t_sirt * 1e3, 2),
                "fbp_psnr_db": round(psnr(fbp, img), 2),
                "sirt_psnr_db": round(psnr(it, img), 2),
            }
            rows.append(row)
            if not args.json:
                print(f"angles={n_ang:4d} noise={sigma:.3f}  "
                      f"FBP {row['fbp_psnr_db']:6.2f} dB "
                      f"({row['fbp_ms']:.1f} ms)   "
                      f"SIRT({args.sirt_iterations}) "
                      f"{row['sirt_psnr_db']:6.2f} dB "
                      f"({row['sirt_ms']:.1f} ms)")
            if (draw and n_ang == args.angles[-1]
                    and sigma == args.noise[-1]):
                from njw_tpu_torch.viz import compare_images, show_sinogram

                show_sinogram(noisy, path=os.path.join(
                    args.output_dir, "sinogram.png"))
                compare_images(
                    {"phantom": img, "FBP": fbp,
                     f"SIRT({args.sirt_iterations})": it},
                    path=os.path.join(args.output_dir,
                                      "reconstruction.png"))

    cone = None
    if args.cone_beam:
        nz = max(32, args.size // 4)
        zz, yy, xx = np.mgrid[0:nz, 0:nz, 0:nz].astype(np.float32)
        c = (nz - 1) / 2
        vol = (((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
               < (0.4 * nz) ** 2).astype(np.float32)
        vol += (((zz - c) ** 2 + (yy - c - nz * 0.15) ** 2
                 + (xx - c) ** 2) < (0.1 * nz) ** 2)
        betas = np.linspace(0, 2 * np.pi, 90, endpoint=False)
        sod, sdd = 2.0 * nz, 4.0 * nz
        proj, t_proj = timed(lambda: cone_beam_project(
            vol, betas, sod=sod, sdd=sdd, det_shape=(nz, nz), device=dev),
            dev)
        rec, t_fdk = timed(lambda: to_numpy(fdk_reconstruct(
            proj, betas, sod=sod, sdd=sdd, output_size=nz)), dev)
        cone = {"nz": nz, "project_ms": round(t_proj * 1e3, 1),
                "fdk_ms": round(t_fdk * 1e3, 1),
                "fdk_psnr_db": round(psnr(rec, vol), 2)}
        if not args.json:
            print(f"cone-beam {nz}^3, 90 views: project "
                  f"{cone['project_ms']} ms, FDK {cone['fdk_ms']} ms, "
                  f"PSNR {cone['fdk_psnr_db']} dB")

    if args.json:
        print(json.dumps({"rows": rows, "cone_beam": cone}))
    else:
        print(f"figures: {args.output_dir}/sinogram.png, "
              f"{args.output_dir}/reconstruction.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
