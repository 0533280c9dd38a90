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

``fir_layout`` mirrors the kernels' launch geometry (``fir_band.cuh``: the
tile of frames, the ring's depth, the blocks an SM, the persistent grid
and whether TMA streams the rows) and ``fir_schedule`` the tiles each
block of that grid walks; ``fir_kernel_attributes`` reads a built kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
# The launch geometry (mirrors fir_band.cuh)
# ---------------------------------------------------------------------------

TILE_FRAMES = 64        # FR: frames a tile
THREADS = 128           # NT: four warps, 16 frames of a tile each
PITCH = 136             # term plane row pitch, in bf16
BOX = 256               # samples a TMA box
SMEM_PER_SM = 233472    # shared bytes an SM (1 KB a block reserved)
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class FIRLayout:
    frames: int          # frames a tile
    stages: int          # tiles the ring holds
    threads: int
    blocks_per_sm: int
    smem_bytes: int      # dynamic shared memory a block
    tiles: int           # rows x runs of frames
    grid: int            # persistent blocks
    streamed: bool       # TMA streams the rows (else the staging branch)


def _terms(dtype: torch.dtype, passes: int) -> int:
    """Signal terms a sample is split into (NA)."""
    if dtype == torch.bfloat16:
        return 1
    return 1 + max(a for a, _ in PLANS[passes])


def fir_layout(rows: int, n: int, dtype=torch.float32, passes: int = 3, *,
               out_dtype=None, sms: int = H100_SMS,
               data_ptr: int = 0) -> FIRLayout:
    """The launch of ``fir_band`` (float32 ``dtype``, ``passes``) or
    ``fir_band_bf16`` (bf16, ``out_dtype`` bf16 unless given) on ``rows``
    x ``n`` at address ``data_ptr`` (the output is allocated aligned) on a
    card with ``sms`` SMs, as ``fir_band.cuh`` computes it. A ring stage
    holds a tile of x in, then the same tile of y out."""
    in_bytes = 2 if dtype == torch.bfloat16 else 4
    out_bytes = 4 if in_bytes == 4 or out_dtype == torch.float32 else 2
    na = _terms(dtype, passes)
    if in_bytes == 2:
        stages = bpsm = 3 if out_bytes == 2 else 2
    else:
        stages, bpsm = (1 if na == 3 else 2), 2
    plane = (TILE_FRAMES + 1) * PITCH
    stage = TILE_FRAMES * FRAME * max(in_bytes, out_bytes)
    smem = stages * (stage + 8) + na * plane * 2
    if bpsm * (smem + 1024) > SMEM_PER_SM:
        raise ValueError(f"{bpsm} blocks of {smem} shared bytes do not fit "
                         "an SM")
    frames = -(-n // FRAME)
    tiles = rows * -(-frames // TILE_FRAMES)
    streamed = (data_ptr % 16 == 0 and (n * in_bytes) % 16 == 0
                and BOX <= n <= 0x7FFFFFFF - TILE_FRAMES * FRAME)
    return FIRLayout(TILE_FRAMES, stages, THREADS, bpsm, smem, tiles,
                     min(tiles, bpsm * sms), streamed)


def fir_schedule(rows: int, n: int, grid: int) -> list[list[tuple]]:
    """For each block of the persistent grid, the (row, first sample) of
    the tiles it walks, in order: block b takes the contiguous tiles
    [b T / G, (b+1) T / G) of the T tiles in row order."""
    runs = -(-(-(-n // FRAME)) // TILE_FRAMES)
    tiles = rows * runs
    return [[(i // runs, (i % runs) * TILE_FRAMES * FRAME)
             for i in range(tiles * b // grid, tiles * (b + 1) // grid)]
            for b in range(grid)]


def fir_kernel_attributes(dtype=torch.float32, passes: int = 3, *,
                          out_dtype=torch.bfloat16, index: int = 0) -> dict:
    """The built kernel that ``fir_band`` (float32, ``passes``) or
    ``fir_band_bf16`` (bf16, ``passes`` = taps_passes, ``out_dtype``)
    launches, on CUDA device ``index``: registers and local (spill) bytes a
    thread, dynamic and static shared bytes, threads, resident blocks an
    SM, frames a tile and ring stages."""
    bf16 = dtype == torch.bfloat16
    name = "fir_band_bf16" if bf16 else "fir_band"
    fn = getattr(_build.load(name), f"{name}_attributes")
    vals = (ctypes.c_int * 8)()
    if bf16:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        args = (passes, int(out_dtype == torch.float32), vals)
    else:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        args = (passes, vals)
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        err = fn(*args)
    if err != 0:
        msg = _build.bind(name, _ARGTYPES_BF16 if bf16 else _ARGTYPES)[1](err)
        raise RuntimeError(f"{name} attributes: {msg.decode()} ({err})")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads",
                     "blocks_per_sm", "static_smem_bytes", "frames",
                     "stages"), vals))


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
