"""Checkpoint and restore a simulation state.

Counterpart of ``njw_tpu/utils/checkpoint.py``, in its file format, so
that a checkpoint written by either package loads in the other:

    save_checkpoint(path, state, step=..., time=..., extra={...})
    state, meta = load_checkpoint(path, like=state_template)

One compressed .npz, written to a temporary name and renamed (no torn
checkpoint), holding the state's leaves as ``leaf_0``, ``leaf_1``, ...
and a JSON ``__meta__`` entry (version, step, time, n_leaves, a
description of the state, the caller's extras). The leaves are the
state's tensors in dataclass field order, depth first, fields set to
``None`` skipped: JAX's flatten order for the same states. A complex
tensor (the spectral states) is written as its (2, ...) stack of real
and imaginary parts, the JAX package's packed form of those states.
Loading matches the template on ``n_leaves`` and each leaf's shape; the
description is informational, as JAX's ``treedef`` string is.

The orbax pair of the JAX module (multi-host sharded checkpoints) has no
counterpart yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _leaves(obj) -> list:
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in _leaves(o)]
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _describe(obj) -> str:
    if obj is None:
        return "None"
    if isinstance(obj, torch.Tensor):
        return "*"
    if dataclasses.is_dataclass(obj):
        inner = ", ".join(f"{f.name}={_describe(getattr(obj, f.name))}"
                          for f in dataclasses.fields(obj))
        return f"{type(obj).__name__}({inner})"
    return "(" + ", ".join(_describe(o) for o in obj) + ")"


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return _to_tensor(next(it), like)
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name), it)
                             for f in dataclasses.fields(like)})
    return type(like)(_unflatten(o, it) for o in like)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.is_complex():
        return np.stack([t.real.numpy(), t.imag.numpy()])
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    want = tuple(like.shape)
    if like.is_complex():
        if a.shape != (2,) + want:
            raise ValueError(f"checkpoint leaf of shape {a.shape} for a "
                             f"complex template of shape {want}")
        a = a[0] + 1j * a[1]
    elif a.shape != want:
        raise ValueError(f"checkpoint leaf of shape {a.shape} for a "
                         f"template of shape {want}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, state: Any, *, step: int = 0,
                    time: float = 0.0, extra: Optional[dict] = None) -> str:
    """Write the state's leaves and the metadata to ``path`` (.npz added
    when absent)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _to_array(t) for i, t in enumerate(leaves)}
    meta = {
        "version": 1,
        "step": int(step),
        "time": float(time),
        "n_leaves": len(leaves),
        "treedef": _describe(state),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, like: Any = None):
    """(state, meta). With a template ``like``, the leaves fill its
    structure as tensors on its tensors' devices and dtypes; without one,
    the state is the list of NumPy leaves."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if like is None:
        return leaves, meta
    n = len(_leaves(like))
    if n != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {n}")
    return _unflatten(like, iter(leaves)), meta


def save_simulation(path: str, sim) -> str:
    """Checkpoint a Simulation: its state, step count, time and config."""
    extra = {}
    cfg = getattr(sim, "config", None)
    if cfg is not None:
        extra["config"] = dataclasses.asdict(cfg)
    return save_checkpoint(path, sim.state, step=sim.step_count,
                           time=sim.time, extra=extra)


def restore_simulation(path: str, sim):
    """Restore state, step and time into a Simulation built with a
    matching config; the stepper's carry starts anew from the state."""
    state, meta = load_checkpoint(path, like=sim.state)
    sim.state = state
    sim.step_count = meta["step"]
    sim.time = meta["time"]
    sim._carry = sim.stepper.init(sim.state)
    return sim
