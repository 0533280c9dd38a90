"""Strided strip copies: the halo exchange's pack and unpack.

``csrc/halo_strips.cu`` copies a list of strips in one launch: each strip
is a box of (planes, rows, columns) float32 with its plane and row
pitches on either side, columns consecutive on both. The sharded
steppers' halo refresh packs an axis's strips of padded blocks into a
collective's send buffer with one launch (``parallel/mesh.py``
``_PairExchange``) and unpacks the receive buffer into the bands with
another (``parallel/halo.py`` ``_Fill``); on a mesh held by one process
the unpack reads the neighbours' strips directly.
The kernel replaces no TPU kernel: XLA fuses those copies into the JAX
package's sharded steps, and PyTorch's ``_foreach_copy_`` copied strided
strips one kernel each.

A copy is a list of (src, dst) pairs of views of one shape, 2-D or 3-D.
``bind_strips`` binds a list once, under the rule of ``ops/_bound.py``,
and is the one dispatch point: on CUDA tensors the kernel's launches, the
strips' descriptors (``strip_descriptors``) and pointers fixed, a call one
ctypes call a launch (one launch per ``MAX_STRIPS`` strips); on CPU
tensors the plain version (``torch._foreach_copy_``). The library is
loaded at the first binding on CUDA tensors, so paths with no mesh never
build or load it. ``copy_strips_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, NamedTuple, Sequence

import torch

from njw_tpu_torch.ops import _build
from njw_tpu_torch.ops._bound import Launch, device_kind, require_cuda

MAX_STRIPS = 80     # csrc/halo_strips.cu kMaxStrips: strips a launch
CHUNK = 1024        # its kChunk: elements a block copies
_INT_MAX = 2**31 - 1

Pairs = Sequence[tuple]   # (src, dst) views of one shape


class StripDesc(NamedTuple):
    """One strip of a launch, as the kernel reads it: the pointers, the
    pitches in elements, the box, and its first chunk in the launch."""

    src: int
    dst: int
    src_plane: int
    src_row: int
    dst_plane: int
    dst_row: int
    planes: int
    rows: int
    cols: int
    first: int


class _Strip(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p)] + [
        (f, ctypes.c_int) for f in StripDesc._fields[2:]]


class _Strips(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("chunks", ctypes.c_int),
                ("s", _Strip * MAX_STRIPS)]


def _box(t: torch.Tensor, name: str) -> tuple:
    """(plane pitch, row pitch, planes, rows, cols) of a 2-D or 3-D view
    whose columns are consecutive."""
    if t.dim() not in (2, 3) or t.dtype != torch.float32:
        raise ValueError(f"{name}: strips are 2-D or 3-D float32 views, "
                         f"not {tuple(t.shape)} {t.dtype}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: a strip's columns must be consecutive "
                         f"(stride {t.stride()})")
    planes = t.shape[0] if t.dim() == 3 else 1
    plane = t.stride(0) if t.dim() == 3 else 0
    return plane, t.stride(-2), planes, t.shape[-2], t.shape[-1]


def strip_descriptors(pairs: Pairs, name: str = "halo_strips"
                      ) -> list[StripDesc]:
    """The descriptors of ``pairs`` in order, empty strips left out, each
    strip's first chunk counted from 0 over the list (the kernel's grid).
    Refuses pairs of other shapes or devices, and boxes past 32 bits."""
    out, first = [], 0
    for src, dst in pairs:
        if src.shape != dst.shape or src.device != dst.device:
            raise ValueError(f"{name}: a strip {tuple(src.shape)} on "
                             f"{src.device} and its target "
                             f"{tuple(dst.shape)} on {dst.device}")
        if src.numel() == 0:
            continue
        sp, sr, planes, rows, cols = _box(src, name)
        dp, dr = _box(dst, name)[:2]
        if max(sp, sr, dp, dr, src.numel()) > _INT_MAX:
            raise ValueError(f"{name}: a strip of {tuple(src.shape)} "
                             "elements or its pitches pass 32 bits")
        out.append(StripDesc(src.data_ptr(), dst.data_ptr(), sp, sr, dp, dr,
                             planes, rows, cols, first))
        first = chunks(out)
    return out


def chunks(descs: Sequence[StripDesc]) -> int:
    """The blocks of a launch of ``descs``: the chunks of every strip."""
    if not descs:
        return 0
    d = descs[-1]
    return d.first + -(-d.planes * d.rows * d.cols // CHUNK)


def copy_strips_cuda(pairs: Pairs) -> None:
    """Copy each src into its dst by the kernel on the current stream, one
    launch per ``MAX_STRIPS`` strips; refuses tensors that are not on a
    CUDA device. ``copy_strips_cuda.launches`` counts the launches."""
    require_cuda("copy_strips_cuda",
                 [("strip", t) for p in pairs for t in p])
    for launch in bind_strips(pairs):
        launch()


def copy_strips_plain(pairs: Pairs) -> None:
    """The plain version: one ``torch._foreach_copy_`` of the pairs."""
    if pairs:
        torch._foreach_copy_([d for _, d in pairs], [s for s, _ in pairs])


copy_strips_cuda.launches = 0


def bind_strips(pairs: Pairs) -> tuple[Callable, ...]:
    """The copy of ``pairs`` bound once, as the calls that make it: on CUDA
    tensors one ``Launch`` per ``MAX_STRIPS`` strips (none for an empty
    list), on CPU tensors one call of the plain version."""
    pairs = list(pairs)
    strip_descriptors(pairs)
    pairs = [(s, d) for s, d in pairs if s.numel()]
    devices = {t.device for p in pairs for t in p}
    if len(devices) > 1:
        raise ValueError(f"halo_strips: strips on {sorted(map(str, devices))}"
                         " in one copy")
    if not pairs:
        return ()
    (dev,) = devices
    if device_kind(pairs[0][0], "halo_strips") == "cpu":
        return (partial(copy_strips_plain, pairs),)
    return tuple(_bind(pairs[i:i + MAX_STRIPS], dev.index)
                 for i in range(0, len(pairs), MAX_STRIPS))


def _bind(pairs: Pairs, index: int) -> Launch:
    descs = strip_descriptors(pairs)
    table = _Strips(len(descs), chunks(descs))
    for slot, d in zip(table.s, descs):
        for f, v in zip(StripDesc._fields, d):
            setattr(slot, f, v)
    launch, err_string = _build.bind(
        "halo_strips", [ctypes.POINTER(_Strips), ctypes.c_void_p])
    return Launch("halo_strips", partial(launch, ctypes.byref(table)), index,
                  err_string, (copy_strips_cuda, "launches"), None,
                  (pairs, table))
