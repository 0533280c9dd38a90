"""What every view of ``njw_tpu_torch.viz`` needs: host arrays and pyplot.

A view takes NumPy arrays, lists, or tensors on any device and of any
dtype (``to_numpy``), and imports matplotlib only when it draws
(``pyplot``), so that ``import njw_tpu_torch.viz`` works where matplotlib
is not installed.
"""
from __future__ import annotations

import numpy as np
import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def to_numpy(x, dtype=None) -> np.ndarray:
    """``x`` as a host NumPy array (of ``dtype`` where given). A tensor is
    detached and copied from its device; bf16 and fp16 go through float32,
    which NumPy can hold. A list or tuple is converted element by element,
    so it may hold tensors on a device."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype in _LOW_PRECISION:
            t = t.float()
        out = t.cpu().numpy()
    elif isinstance(x, (list, tuple)) and any(
            isinstance(e, (torch.Tensor, list, tuple)) for e in x):
        out = np.asarray([to_numpy(e) for e in x])
    else:
        out = np.asarray(x)
    return out if dtype is None else out.astype(dtype, copy=False)


def pyplot():
    """matplotlib's pyplot on the Agg backend (headless). Raises
    ImportError naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "njw_tpu_torch.viz draws with matplotlib, which is not "
            "installed: pip install matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported (the views can draw)."""
    try:
        pyplot()
    except ImportError:
        return False
    return True
