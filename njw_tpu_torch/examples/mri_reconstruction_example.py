"""MRI reconstruction study: build a phantom, undersample its k-space at
several acceleration factors, and compare zero-filled, CG-SENSE, TV
primal-dual and wavelet-FISTA reconstructions by PSNR, with a PNG panel
per acceleration. Counterpart of ``examples/mri_reconstruction_example.py``.

    python -m njw_tpu_torch.examples.mri_reconstruction_example \\
        --size 128 --accelerations 2 3 4 --coils 4 --output-dir out/
"""
import argparse
import json
import os

import numpy as np

from njw_tpu_torch.examples._common import add_device, can_draw
from njw_tpu_torch.medical import (
    MRIReconstructor, reconstruct_compressed_sensing,
    reconstruct_primal_dual,
)
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import to_numpy


def shepp_logan_like(n):
    """Soft-tissue phantom: nested ellipses with distinct intensities."""
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


def coil_maps(n, n_coils):
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1)
    centers = [(0, 0), (0, 1), (1, 0), (1, 1),
               (0.5, 0), (0.5, 1), (0, 0.5), (1, 0.5)][:n_coils]
    sens = np.stack([
        np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.4)
        for cy, cx in centers
    ]).astype(np.complex64)
    return sens / np.sqrt((np.abs(sens) ** 2).sum(0, keepdims=True))


def psnr(rec, ref):
    mse = float(np.mean((to_numpy(rec) - ref) ** 2))
    return float(10.0 * np.log10(float(ref.max()) ** 2 / max(mse, 1e-20)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.mri_reconstruction_example",
        description=__doc__)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--accelerations", type=int, nargs="*", default=[2, 4])
    p.add_argument("--coils", type=int, default=4)
    p.add_argument("--noise", type=float, default=0.002,
                   help="k-space noise sigma relative to DC")
    p.add_argument("--cg-iterations", type=int, default=15)
    p.add_argument("--pd-iterations", type=int, default=80)
    p.add_argument("--cs-iterations", type=int, default=40)
    p.add_argument("--output-dir", default="./output")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    draw = can_draw("mri_reconstruction_example")
    n = args.size
    img = shepp_logan_like(n)
    sens = coil_maps(n, args.coils)
    rng = np.random.default_rng(0)

    k_full = np.fft.fftshift(
        np.fft.fft2(sens * img[None], norm="ortho"), axes=(-2, -1))
    k_full = k_full + args.noise * np.abs(k_full).max() * (
        rng.standard_normal(k_full.shape)
        + 1j * rng.standard_normal(k_full.shape))

    rows = []
    for r in args.accelerations:
        recon = MRIReconstructor(method="cg_sense",
                                 num_iterations=args.cg_iterations,
                                 acceleration_factor=r,
                                 sensitivity_maps=sens, device=dev)
        mask = to_numpy(recon.undersampling_mask(n, n))
        ku = mask[None] * k_full
        # single-coil combined k-space for the single-channel methods
        k1 = mask * np.fft.fftshift(np.fft.fft2(
            img.astype(np.complex64), norm="ortho"))

        zf = np.abs((np.conj(sens) * np.fft.ifft2(
            np.fft.ifftshift(ku, axes=(-2, -1)), norm="ortho")).sum(0))
        cg = to_numpy(recon.process(ku, mask))
        pd = to_numpy(reconstruct_primal_dual(
            k1, mask, num_iterations=args.pd_iterations, tv_weight=0.02,
            device=dev))
        cs = to_numpy(reconstruct_compressed_sensing(
            k1, mask, num_iterations=args.cs_iterations, lam=0.01,
            device=dev))

        row = {"acceleration": r,
               "sampled_fraction": round(float(mask.mean()), 3),
               "psnr_zero_filled": round(psnr(zf, img), 2),
               "psnr_cg_sense": round(psnr(cg, img), 2),
               "psnr_tv_primal_dual": round(psnr(pd, img), 2),
               "psnr_cs_wavelet": round(psnr(cs, img), 2)}
        rows.append(row)
        print(json.dumps(row))

        if draw:
            from njw_tpu_torch.viz._common import pyplot

            plt = pyplot()
            fig, axes = plt.subplots(1, 5, figsize=(16, 3.6))
            for ax, (title, im) in zip(axes, [
                ("phantom", img), (f"zero-filled R={r}", zf),
                ("CG-SENSE", cg), ("TV primal-dual", pd),
                ("CS wavelet", cs),
            ]):
                ax.imshow(im, cmap="gray", vmin=0, vmax=img.max())
                ax.set_title(title, fontsize=10)
                ax.axis("off")
            fig.tight_layout()
            out = os.path.join(args.output_dir, f"recon_r{r}.png")
            fig.savefig(out, dpi=110)
            plt.close(fig)

    with open(os.path.join(args.output_dir, "psnr.json"), "w") as fh:
        json.dump(rows, fh, indent=2)
    print(f"panels + psnr.json in {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
