"""Output managers: CSV, NPZ, NetCDF-3 and VTK writers, their factory and
field statistics.

Counterpart of ``njw_tpu/weather/output.py``. Formats:

  csv     one file per snapshot, long format (step, time, field, y, x, value)
  npz     compressed arrays per snapshot, with a JSON ``__meta__`` entry
  netcdf  classic NetCDF-3 (``njw_tpu_torch.utils.netcdf3``)
  vtk     legacy VTK structured-points ASCII (ParaView)

Each manager has ``write(fields, step, time)`` and ``close()``; a field
may be a tensor on any device or an array, and becomes a NumPy array only
here, at the write. ``attach_output`` hands back the callback that
``Simulation.run(callback=...)`` calls after each chunk.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class OutputConfig:
    path: str = "./output"
    prefix: str = "weather"
    format: str = "npz"  # csv | npz | netcdf | vtk
    fields: Optional[list[str]] = None  # None = all


def to_numpy(v) -> np.ndarray:
    """A tensor (on any device) or an array as a NumPy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class OutputManager:
    """Base class: field selection and file names."""

    def __init__(self, config: OutputConfig):
        self.config = config
        os.makedirs(config.path, exist_ok=True)
        self.written: list[str] = []

    def _select(self, fields: dict) -> dict[str, np.ndarray]:
        names = self.config.fields
        return {k: to_numpy(v) for k, v in fields.items()
                if (names is None or k in names) and hasattr(v, "shape")}

    def _fname(self, step: int, ext: str) -> str:
        return os.path.join(self.config.path,
                            f"{self.config.prefix}_{step:08d}.{ext}")

    def write(self, fields: dict, step: int, time: float) -> str:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CSVOutputManager(OutputManager):
    """Long-format CSV."""

    def write(self, fields, step, time):
        path = self._fname(step, "csv")
        sel = self._select(fields)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["step", "time", "field", "y", "x", "value"])
            for name, arr in sel.items():
                a2 = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 2 else arr
                for yy in range(a2.shape[0]):
                    row_vals = a2[yy]
                    for xx in range(a2.shape[1]):
                        w.writerow([step, time, name, yy, xx,
                                    float(row_vals[xx])])
        self.written.append(path)
        return path


class NPZOutputManager(OutputManager):
    """Self-describing compressed binary."""

    def write(self, fields, step, time):
        path = self._fname(step, "npz")
        sel = self._select(fields)
        meta = json.dumps({"step": step, "time": time,
                           "fields": sorted(sel)})
        np.savez_compressed(path, __meta__=meta, **sel)
        self.written.append(path)
        return path


class NetCDFOutputManager(OutputManager):
    """Classic NetCDF-3 files (``njw_tpu_torch.utils.netcdf3``): 2-D
    fields on (y, x), 3-D ones on (level, y, x), anything else a
    scalar."""

    def write(self, fields, step, time):
        from njw_tpu_torch.utils.netcdf3 import write_netcdf

        path = self._fname(step, "nc")
        sel = self._select(fields)
        dims: dict[str, int] = {}
        variables = {}
        for name, arr in sel.items():
            if arr.ndim == 2:
                ny, nx = arr.shape
                dims.setdefault("y", ny)
                dims.setdefault("x", nx)
                variables[name] = (("y", "x"), arr)
            elif arr.ndim == 3:
                lev, ny, nx = arr.shape
                dims.setdefault("level", lev)
                dims.setdefault("y", ny)
                dims.setdefault("x", nx)
                variables[name] = (("level", "y", "x"), arr)
            else:
                variables[name] = ((), arr.reshape(()))
        write_netcdf(path, variables, dims,
                     global_attrs={"step": int(step), "time": float(time),
                                   "source": "njw_tpu_torch"})
        self.written.append(path)
        return path


class VTKOutputManager(OutputManager):
    """Legacy VTK structured-points ASCII."""

    def write(self, fields, step, time):
        path = self._fname(step, "vtk")
        sel = {k: v for k, v in self._select(fields).items() if v.ndim == 2}
        if not sel:
            raise ValueError("VTK writer needs at least one 2-D field")
        ny, nx = next(iter(sel.values())).shape
        with open(path, "w") as fh:
            fh.write("# vtk DataFile Version 3.0\n")
            fh.write(f"njw_tpu weather step={step} time={time}\n")
            fh.write("ASCII\nDATASET STRUCTURED_POINTS\n")
            fh.write(f"DIMENSIONS {nx} {ny} 1\n")
            fh.write("ORIGIN 0 0 0\nSPACING 1 1 1\n")
            fh.write(f"POINT_DATA {nx * ny}\n")
            for name, arr in sel.items():
                fh.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                np.savetxt(fh, arr.reshape(-1), fmt="%.7g")
        self.written.append(path)
        return path


_MANAGERS: dict[str, Callable[..., OutputManager]] = {
    "csv": CSVOutputManager,
    "npz": NPZOutputManager,
    "netcdf": NetCDFOutputManager,
    "vtk": VTKOutputManager,
}


def create_output_manager(config: OutputConfig) -> OutputManager:
    try:
        return _MANAGERS[config.format](config)
    except KeyError:
        raise ValueError(
            f"unknown output format {config.format!r}; "
            f"available: {sorted(_MANAGERS)}"
        ) from None


@dataclass
class FieldStatistics:
    name: str
    min: float
    max: float
    mean: float
    std: float
    finite_fraction: float

    @classmethod
    def of(cls, name: str, arr) -> "FieldStatistics":
        a = to_numpy(arr).astype(np.float64)
        finite = np.isfinite(a)
        af = a[finite] if finite.any() else np.zeros(1)
        return cls(
            name=name, min=float(af.min()), max=float(af.max()),
            mean=float(af.mean()), std=float(af.std()),
            finite_fraction=float(finite.mean()),
        )


def attach_output(sim, config: OutputConfig):
    """(manager, callback): the callback writes ``sim.output_fn`` of the
    state at each ``Simulation.run(callback=...)`` call."""
    manager = create_output_manager(config)

    def callback(s):
        fields = s.output_fn(s.state) if s.output_fn else {}
        manager.write(fields, s.step_count, s.time)

    return manager, callback
