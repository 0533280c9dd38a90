"""Carry FIR filters and their streaming state across from the JAX package.

Both packages exchange NumPy arrays only: a JAX ``FIRFilter`` is read by
its ``taps``, a JAX ``StreamingFIR`` by its ``taps`` and the input tail it
carries between chunks (``_tail``), so this module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.signal.filters import FIRFilter, StreamingFIR


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
