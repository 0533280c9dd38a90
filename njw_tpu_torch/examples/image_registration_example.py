"""Image registration study: recover a known synthetic transform with
rigid or affine gradient-descent registration (MSE or mutual-information
metric, gradients by autograd), then refine a residual smooth warp with
deformable B-spline registration. Counterpart of
``examples/image_registration_example.py``.

    python -m njw_tpu_torch.examples.image_registration_example \\
        --size 128 --metric mse --ty 4 --tx -3 --theta 0.08 \\
        --grid-shape 8 8 --json
"""
import argparse
import json
import os

import numpy as np

from njw_tpu_torch.examples._common import add_device, can_draw
from njw_tpu_torch.medical.registration import (
    bspline_displacement, register_deformable, register_images,
    warp_deformable, warp_image,
)
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import to_numpy


def make_image(n: int) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    img = (np.sin(x / 7) * np.cos(y / 9)
           + np.exp(-((x - n * 0.5) ** 2 + (y - n * 0.42) ** 2)
                    / (n * 3.2))
           + 0.5 * np.exp(-((x - n * 0.25) ** 2 + (y - n * 0.7) ** 2)
                          / (n * 1.5)))
    return img.astype(np.float32)


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((to_numpy(a) - to_numpy(b)) ** 2)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.image_registration_example",
        description=__doc__)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--metric", default="mse", choices=["mse", "mi"])
    p.add_argument("--method", default="rigid",
                   choices=["rigid", "affine"])
    p.add_argument("--ty", type=float, default=4.0,
                   help="true y translation (pixels)")
    p.add_argument("--tx", type=float, default=-3.0)
    p.add_argument("--theta", type=float, default=0.08,
                   help="true rotation (radians)")
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--grid-shape", type=int, nargs=2, default=[6, 6],
                   help="B-spline control grid for the deformable stage")
    p.add_argument("--deformable-iterations", type=int, default=150)
    p.add_argument("--bump", type=float, default=1.5,
                   help="amplitude (px) of the residual smooth warp the "
                        "deformable stage must recover")
    p.add_argument("--output-dir", default=None,
                   help="write before/after PNGs here")
    p.add_argument("--json", action="store_true")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    fixed = make_image(args.size)
    true_params = [args.ty, args.tx, args.theta, 1.0, 1.0]
    moving = to_numpy(warp_image(fixed, true_params, device=dev))

    # add a smooth residual deformation the rigid stage cannot explain
    rng = np.random.default_rng(0)
    ctrl_true = (args.bump * rng.standard_normal(
        (2, 4, 4))).astype(np.float32)
    moving = to_numpy(warp_deformable(moving, ctrl_true, device=dev))

    params, warped, hist = register_images(
        fixed, moving, method=args.method, metric=args.metric,
        n_iterations=args.iterations, pyramid_levels=3,
        optimizer="adam", learning_rate=0.5, device=dev)
    params, warped, hist = to_numpy(params), to_numpy(warped), \
        to_numpy(hist)
    rigid = {
        "recovered": [round(float(v), 3) for v in params[:3]],
        "true_inverse_approx": [-args.ty, -args.tx, -args.theta],
        "loss_first": round(float(hist[0]), 5),
        "loss_last": round(float(hist[-1]), 5),
        "rmse_before": round(rmse(fixed, moving), 4),
        "rmse_after": round(rmse(fixed, warped), 4),
    }

    ctrl, warped_d, hist_d = register_deformable(
        fixed, warped, grid_shape=tuple(args.grid_shape),
        n_iterations=args.deformable_iterations, device=dev)
    warped_d, hist_d = to_numpy(warped_d), to_numpy(hist_d)
    disp = to_numpy(bspline_displacement(ctrl, fixed.shape, device=dev))
    deformable = {
        "rmse_after": round(rmse(fixed, warped_d), 4),
        "loss_first": round(float(hist_d[0]), 5),
        "loss_last": round(float(hist_d[-1]), 5),
        "max_displacement_px": round(float(np.abs(disp).max()), 3),
    }

    out = {"size": args.size, "metric": args.metric,
           "rigid": rigid, "deformable": deformable}
    if args.output_dir and can_draw("image_registration_example"):
        from njw_tpu_torch.viz import compare_images

        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir, "registration.png")
        compare_images(
            {"fixed": fixed, "moving": moving, "rigid": warped,
             "rigid+deformable": warped_d}, path=path)
        out["figure"] = path

    if args.json:
        print(json.dumps(out))
    else:
        print(f"true transform  [ty tx theta] = "
              f"[{args.ty} {args.tx} {args.theta}]")
        print(f"recovered (inverse) = {rigid['recovered']}  "
              f"loss {rigid['loss_first']} -> {rigid['loss_last']}")
        print(f"RMSE vs fixed: {rigid['rmse_before']} (moving) -> "
              f"{rigid['rmse_after']} (rigid) -> "
              f"{deformable['rmse_after']} (deformable)")
        print(f"deformable max |displacement| = "
              f"{deformable['max_displacement_px']} px "
              f"(injected bump amplitude {args.bump} px)")
        if "figure" in out:
            print(f"figure: {out['figure']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
