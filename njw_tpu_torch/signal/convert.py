"""Carry FIR and IIR filters and their streaming state across from the
JAX package.

Both packages exchange NumPy arrays only: a JAX ``FIRFilter`` is read by
its ``taps``, a JAX ``StreamingFIR`` by its ``taps`` and the input tail it
carries between chunks (``_tail``), a JAX ``IIRFilter`` by its ``sos``
and a JAX ``StreamingIIR`` by its ``sos`` and the (S, 2, B) section
states it carries (``_z``), so this module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.signal.filters import (
    FIRFilter, IIRFilter, StreamingFIR, StreamingIIR,
)


def fir_filter_from(other, device="cuda") -> FIRFilter:
    """The port's ``FIRFilter`` with the taps of ``other`` (any object
    with a ``taps`` array, such as a JAX ``FIRFilter``)."""
    return FIRFilter(taps=np.asarray(other.taps, np.float32), device=device)


def streaming_fir_from(other, device="cuda") -> StreamingFIR:
    """The port's ``StreamingFIR`` in the state of ``other`` (a JAX
    ``StreamingFIR``, or a dict from ``streaming_fir_state``): its taps
    and the carried tail of the last taps-1 input samples."""
    state = other if isinstance(other, dict) else {
        "taps": other.taps, "tail": other._tail}
    sf = StreamingFIR(np.asarray(state["taps"], np.float32), device=device)
    tail = np.asarray(state["tail"], np.float32)
    if tail.shape != tuple(sf._tail.shape):
        raise ValueError(f"tail of shape {tail.shape}, expected "
                         f"{tuple(sf._tail.shape)} for {len(sf.taps)} taps")
    sf._tail = torch.from_numpy(tail.copy()).to(sf.device)
    return sf


def streaming_fir_state(sf: StreamingFIR) -> dict[str, np.ndarray]:
    """The state of a port ``StreamingFIR`` as NumPy arrays."""
    return {"taps": sf.taps.copy(), "tail": sf._tail.cpu().numpy()}


def iir_filter_from(other, device="cuda") -> IIRFilter:
    """The port's ``IIRFilter`` with the sections of ``other`` (any object
    with an ``sos`` array, such as a JAX ``IIRFilter``)."""
    return IIRFilter(sos=np.asarray(other.sos, np.float32), device=device)


def streaming_iir_from(other, device="cuda") -> StreamingIIR:
    """The port's ``StreamingIIR`` in the state of ``other`` (a JAX
    ``StreamingIIR``, or a dict from ``streaming_iir_state``): its sections
    and the carried (S, 2, B) transposed-DF-II states."""
    state = other if isinstance(other, dict) else {
        "sos": other.sos, "z": other._z}
    sos = np.asarray(state["sos"], np.float32)
    z = np.asarray(state["z"], np.float32)
    if z.ndim != 3 or z.shape[:2] != (sos.shape[0], 2):
        raise ValueError(f"state of shape {z.shape}, expected "
                         f"({sos.shape[0]}, 2, batch) for {sos.shape[0]} "
                         "sections")
    si = StreamingIIR(sos, batch=z.shape[2], device=device)
    si._z = torch.from_numpy(z.copy()).to(si.device)
    return si


def streaming_iir_state(si: StreamingIIR) -> dict[str, np.ndarray]:
    """The state of a port ``StreamingIIR`` as NumPy arrays."""
    return {"sos": si.sos.cpu().numpy().copy(),
            "z": si._z.cpu().numpy().copy()}
