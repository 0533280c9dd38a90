"""Batched causal FIR on the tensor cores: CUDA kernels and plain versions.

Counterpart of ``njw_tpu/signal/fir_pallas.py``. Its four entry points
keep their JAX names' meaning and checks:

  fir_batch_lanes  K7 (fir_batch_pallas_lanes; fir_apply's batch branch)
  fir_batch        K9 (fir_batch_pallas)
  fir_batch_flat   K10 (fir_batch_pallas_flat)
  fir_batch_bf16   K8 (fir_batch_pallas_bf16)

All compute y[b, t] = sum_{d<k} h[d] x[b, t-d] with zero initial state and
k <= 128, as one product per 128-sample frame of the window [previous
frame | frame] with the band matrix [H1; H0]. K7, K9 and K10 differ only in
how the TPU lays frames out, so one kernel, ``ops/csrc/fir_band.cu``,
serves all three; ``ops/csrc/fir_band_bf16.cu`` serves K8. The TPU's block
parameters (``block_rows``, ``block_frames``) and the ``scratch`` forms
are accepted and do not change the value.

``passes`` is the JAX kernels' precision: 1-3 add the products x_hi H_hi,
x_lo H_hi, x_hi H_lo of bf16 terms with float32 accumulation; 6 (the TPU's
Precision.HIGH) is the same three; 0 (Precision.HIGHEST) the six products
of three-term splits, float32 accuracy.

Both kernels dispatch in one place, ``_runner``: the kernel's launch for
CUDA tensors, its plain PyTorch version (the same splits and products, as
float32 matrix products) for CPU tensors. ``fir_band_cuda.launches`` and
``fir_band_bf16_cuda.launches`` count the launches. Nothing catches a
build or launch failure and falls back.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

from njw_tpu_torch.ops import _build
from njw_tpu_torch.signal.filters import (
    FRAME, FIRBands, as_signal, fir_bands, split_terms, taps_array,
)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])

# (signal term, band term) of each product, in the order they are summed
PLANS = {
    0: ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)),
    1: ((0, 0),),
    2: ((0, 0), (1, 0)),
    3: ((0, 0), (1, 0), (0, 1)),
    6: ((0, 0), (1, 0), (0, 1)),
}
TAPS_PLANS = {1: ((0, 0),), 2: ((0, 0), (0, 1))}
OUT_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# The public entry points (the JAX signatures)
# ---------------------------------------------------------------------------


def _signal_2d(x, dtype, name: str) -> torch.Tensor:
    x = as_signal(x, dtype=dtype)
    if x.ndim != 2:
        raise ValueError(f"{name} expects (B, n) signals")
    return x.contiguous()


def _checked_taps(taps):
    t = taps_array(taps)
    if t.shape[0] > FRAME:
        raise ValueError(f"taps must be <= {FRAME}")
    return t


def fir_batch_lanes(x, taps, *, block_rows: int = 1000,
                    block_frames: int = 8, passes: int = 3,
                    scratch: bool = True) -> torch.Tensor:
    """Causal batch FIR, float32 (K7, the kernel of ``fir_apply``'s batch
    branch). ``passes`` in (0, 1, 2, 3, 6); both ``scratch`` forms give
    the same value."""
    x = _signal_2d(x, torch.float32, "fir_batch_lanes")
    taps = _checked_taps(taps)
    return _call(_runner(x, _launch, _plain), x, taps, passes)


def fir_batch(x, taps, *, block_rows: int = 40, block_frames: int = 128,
              passes: int = 3) -> torch.Tensor:
    """Causal batch FIR, float32 (K9). ``passes`` in (1, 2, 3)."""
    x = _signal_2d(x, torch.float32, "fir_batch")
    taps = _checked_taps(taps)
    if passes not in (1, 2, 3):
        raise ValueError(f"fir_batch: passes must be 1, 2 or 3, got {passes}")
    return _call(_runner(x, _launch, _plain), x, taps, passes)


def fir_batch_flat(x, taps, *, block_frames: int = 4096,
                   passes: int = 3) -> torch.Tensor:
    """Causal batch FIR, float32 (K10): the same value as ``fir_batch``;
    the JAX kernel's conditions on the shape stay."""
    x = _signal_2d(x, torch.float32, "fir_batch_flat")
    b, n = x.shape
    k = taps_array(taps).shape[0]
    if (b * n) % FRAME != 0:
        raise ValueError("flat kernel needs (B*n) % 128 == 0")
    if k > FRAME or n < 2 * FRAME:
        raise ValueError("taps must be <= 128 and n >= 256")
    if passes not in (1, 2, 3):
        raise ValueError(f"fir_batch_flat: passes must be 1, 2 or 3, "
                         f"got {passes}")
    return _call(_runner(x, _launch, _plain), x, taps, passes)


def fir_batch_bf16(x, taps, *, block_rows: int = 1000,
                   block_frames: int = 64, taps_passes: int = 1,
                   out_dtype=torch.bfloat16,
                   scratch: bool = False) -> torch.Tensor:
    """Causal batch FIR of a bf16 signal (K8): float32 input is rounded to
    bf16 once; float32 accumulation; output in ``out_dtype`` (bf16 or
    float32). ``taps_passes`` = 2 adds the product with the taps' bf16
    residual."""
    x = x if isinstance(x, torch.Tensor) else as_signal(x)
    if x.ndim != 2:
        raise ValueError("fir_batch_bf16 expects (B, n) signals")
    x = x.to(torch.bfloat16).contiguous()
    taps = _checked_taps(taps)
    return _call_bf16(_runner(x, _launch_bf16, _plain_bf16), x, taps,
                      taps_passes, out_dtype)


# ---------------------------------------------------------------------------
# fir_band: the float32 kernel
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: x must be {dtype}, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be (B, n), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def _band(x: torch.Tensor, taps) -> tuple[FIRBands, int]:
    t = taps_array(taps)
    return fir_bands(t, x.device), int(t.shape[0])


def fir_band_cuda(x: torch.Tensor, taps, *, passes: int = 3) -> torch.Tensor:
    """Launch ``fir_band.cu`` on the current stream. Refuses tensors that
    are not on a CUDA device. ``fir_band_cuda.launches`` counts the
    launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fir_band_cuda: x is on {x.device}; the kernel "
                         "takes CUDA tensors only")
    return _call(_launch, x, taps, passes)


def fir_band_plain(x: torch.Tensor, taps, *, passes: int = 3) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    return _call(_plain, x, taps, passes)


def _call(run: Callable, x, taps, passes: int) -> torch.Tensor:
    _check(x, torch.float32, "fir_band")
    if passes not in PLANS:
        raise ValueError(f"passes must be one of {sorted(PLANS)}, got {passes}")
    bands, k = _band(x, taps)
    return run(x, bands, k, passes)


def _launch(x: torch.Tensor, bands: FIRBands, k: int,
            passes: int) -> torch.Tensor:
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    launch, err_string = _build.bind("fir_band", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), bands.terms.data_ptr(), y.data_ptr(),
                     x.shape[0], x.shape[1], k, passes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir_band kernel launch failed: "
                           f"{err_string(err).decode()} ({err})")
    fir_band_cuda.launches += 1
    return y


fir_band_cuda.launches = 0


def _windows(x: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, frames, 256): [frame f-1 | frame f] for each frame,
    zero before the first sample and past the last."""
    n = x.shape[1]
    frames = -(-n // FRAME)
    return F.pad(x, (FRAME, frames * FRAME - n)).unfold(1, 2 * FRAME, FRAME)


def _product(terms_x, terms_h, plan, n: int) -> torch.Tensor:
    y = None
    for a, b in plan:
        p = _windows(terms_x[a]) @ terms_h[b]
        y = p if y is None else y.add_(p)
    return y.flatten(1)[:, :n]


def _plain(x: torch.Tensor, bands: FIRBands, k: int,
           passes: int) -> torch.Tensor:
    plan = PLANS[passes]
    na = 1 + max(a for a, _ in plan)
    nb = 1 + max(b for _, b in plan)
    return _product(split_terms(x, na), bands.terms[:nb].float(), plan,
                    x.shape[1]).contiguous()


# ---------------------------------------------------------------------------
# fir_band_bf16: the bf16-signal kernel
# ---------------------------------------------------------------------------


def fir_band_bf16_cuda(x: torch.Tensor, taps, *, taps_passes: int = 1,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch ``fir_band_bf16.cu`` on the current stream (CUDA tensors
    only). ``fir_band_bf16_cuda.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fir_band_bf16_cuda: x is on {x.device}; the "
                         "kernel takes CUDA tensors only")
    return _call_bf16(_launch_bf16, x, taps, taps_passes, out_dtype)


def fir_band_bf16_plain(x: torch.Tensor, taps, *, taps_passes: int = 1,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """The bf16 kernel's function in plain PyTorch, on any device."""
    return _call_bf16(_plain_bf16, x, taps, taps_passes, out_dtype)


def _call_bf16(run: Callable, x, taps, taps_passes: int,
               out_dtype) -> torch.Tensor:
    _check(x, torch.bfloat16, "fir_band_bf16")
    if taps_passes not in TAPS_PLANS:
        raise ValueError(f"taps_passes must be 1 or 2, got {taps_passes}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {out_dtype}")
    bands, k = _band(x, taps)
    return run(x, bands, k, taps_passes, out_dtype)


def _runner(x: torch.Tensor, launch: Callable, plain: Callable) -> Callable:
    """The one dispatch point: the launch for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cuda":
        return launch
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"fir_band: unsupported device {x.device}")


def _launch_bf16(x: torch.Tensor, bands: FIRBands, k: int, taps_passes: int,
                 out_dtype) -> torch.Tensor:
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    launch, err_string = _build.bind("fir_band_bf16", _ARGTYPES_BF16)
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), bands.terms.data_ptr(), y.data_ptr(),
                     x.shape[0], x.shape[1], k, taps_passes,
                     int(out_dtype == torch.float32),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir_band_bf16 kernel launch failed: "
                           f"{err_string(err).decode()} ({err})")
    fir_band_bf16_cuda.launches += 1
    return y


fir_band_bf16_cuda.launches = 0


def _plain_bf16(x: torch.Tensor, bands: FIRBands, k: int, taps_passes: int,
                out_dtype) -> torch.Tensor:
    plan = TAPS_PLANS[taps_passes]
    y = _product([x.float()], bands.terms[:taps_passes].float(), plan,
                 x.shape[1])
    return y.to(out_dtype).contiguous()
