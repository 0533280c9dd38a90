"""Full float32 arithmetic for matrix products and convolutions.

PyTorch lets a process run float32 matrix products (cuBLAS) and
convolutions (cuDNN) in TF32, which keeps 10 bits of the mantissa. The
JAX package runs its float32 contractions at ``Precision.HIGHEST``, and
the port's modules that hold to its tolerances enter ``float32_products``
around theirs, whatever the process has set.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_products():
    """Run the enclosed matrix products and convolutions in full float32
    (no TF32), and restore the process's settings after."""
    prev_matmul = torch.get_float32_matmul_precision()
    prev_conv = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev_conv
        torch.set_float32_matmul_precision(prev_matmul)
