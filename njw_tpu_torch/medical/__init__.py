"""Medical imaging: counterpart of ``njw_tpu.medical``.

CT (parallel-beam Radon transform, filtered backprojection with four ramp
windows, SIRT; cone-beam projection and FDK), MRI (Cartesian, bilinear
and Kaiser-Bessel gridding with Pipe-Menon density compensation,
CG-SENSE, TV primal-dual, wavelet FISTA, homodyne partial Fourier, the
``MRIReconstructor`` facade), filters (convolution, gaussian, median,
bilateral, non-local means), segmentation (thresholds, region growing,
watershed, Chan-Vese, MRF) and registration (rigid and affine by
gradient descent or Adam, B-spline deformable). The JAX package has no
Pallas kernel here (XLA runs it), and the port runs on PyTorch's own
operations: cuFFT, gathers, ``index_add_``, cuDNN convolutions and
cuBLAS products in full float32, autograd. A function takes tensors
(which stay on their device) or NumPy arrays (which go to ``device``,
CUDA unless given).
"""
from njw_tpu_torch.medical.image import MedicalImage, load_image, save_image
from njw_tpu_torch.medical.ct import (
    cone_beam_project, fdk_reconstruct, filtered_backprojection, radon, sirt,
)
from njw_tpu_torch.medical.mri import (
    MRIReconstructor, grid_noncartesian, gridding_reconstruct,
    pipe_menon_dcf, reconstruct_cg, reconstruct_compressed_sensing,
    reconstruct_kspace, reconstruct_partial_fourier,
    reconstruct_primal_dual,
)
from njw_tpu_torch.medical.filters import (
    apply_filter, bilateral_filter, convolve2d, gaussian_filter,
    median_filter, nlm_filter,
)
from njw_tpu_torch.medical.segmentation import (
    apply_segmentation, chan_vese, mrf_segment, otsu_threshold,
    region_growing, threshold, watershed,
)
from njw_tpu_torch.medical.registration import (
    mse_metric, mutual_information, register_deformable, register_images,
    warp_image,
)


def reconstruct_ct(projections, angles, method: str = "fbp", **kw):
    """FBP ('fbp', 'filtered_backprojection') or SIRT ('sirt',
    'iterative') of a parallel-beam sinogram."""
    if method in ("fbp", "filtered_backprojection"):
        return filtered_backprojection(projections, angles, **kw)
    if method in ("sirt", "iterative"):
        return sirt(projections, angles, **kw)
    raise ValueError(f"unknown CT method {method!r}")


__all__ = [
    "MRIReconstructor", "MedicalImage", "apply_filter", "apply_segmentation",
    "bilateral_filter", "chan_vese", "cone_beam_project", "convolve2d",
    "fdk_reconstruct", "filtered_backprojection", "gaussian_filter",
    "grid_noncartesian", "gridding_reconstruct", "load_image",
    "median_filter", "mrf_segment", "mse_metric", "mutual_information",
    "nlm_filter", "otsu_threshold", "pipe_menon_dcf", "radon",
    "reconstruct_cg", "reconstruct_compressed_sensing", "reconstruct_ct",
    "reconstruct_kspace", "reconstruct_partial_fourier",
    "reconstruct_primal_dual", "region_growing", "register_deformable",
    "register_images", "save_image", "sirt", "threshold", "warp_image",
    "watershed",
]
