"""Grid specification, physical constants and prognostic state.

Counterpart of ``njw_tpu/weather/grid.py``. ``GridSpec`` and
``PhysicsParams`` are frozen dataclasses of Python numbers; ``WeatherState``
is a dataclass of ``(ny, nx)`` tensors (x is the fastest axis, as in the JAX
package) on one device.
"""
from __future__ import annotations

from typing import ClassVar, Iterator, Optional

import numpy as np
import torch

from njw_tpu_torch.utils.pytree import pytree_dataclass, static_field

STATE_FIELDS = ("u", "v", "h", "p", "T", "q", "ps")


@pytree_dataclass
class GridSpec:
    """Static grid geometry: sizes, spacings, boundary condition, grid type."""

    nx: int = static_field(default=256)
    ny: int = static_field(default=256)
    levels: int = static_field(default=1)
    dx: float = static_field(default=1.0)
    dy: float = static_field(default=1.0)
    # periodic | clamped | outflow | reflective
    bc: str = static_field(default="periodic")
    # cartesian (A-grid) | staggered (C-grid)
    grid_type: str = static_field(default="cartesian")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def shape3(self) -> tuple[int, int, int]:
        return (self.levels, self.ny, self.nx)

    def coords(self, device, dtype=torch.float32):
        """(y, x) index coordinate tensors of shape (ny, 1) and (1, nx)."""
        y = torch.arange(self.ny, dtype=dtype, device=device)[:, None]
        x = torch.arange(self.nx, dtype=dtype, device=device)[None, :]
        return y, x

    def validate(self) -> None:
        if self.bc not in ("periodic", "clamped", "outflow", "reflective"):
            raise ValueError(f"unknown boundary condition: {self.bc!r}")
        if self.grid_type not in ("cartesian", "staggered"):
            raise ValueError(
                f"unknown grid type: {self.grid_type!r} for a planar "
                "GridSpec (spherical_harmonic and icosahedral are global "
                "cores: Simulation.from_config builds them)")
        if self.grid_type == "staggered" and self.bc != "periodic":
            raise ValueError("the C-grid core is periodic-only")
        if self.nx < 3 or self.ny < 3:
            raise ValueError("grid must be at least 3x3 for central differences")


@pytree_dataclass
class PhysicsParams:
    """Physical constants of the dynamical core (Python floats)."""

    gravity: float = 9.81
    coriolis_f: float = 0.0
    beta: float = 0.0
    viscosity: float = 0.0
    diffusivity: float = 0.0
    mean_depth: float = 10.0  # semi-implicit linearisation depth


class FieldState:
    """The state protocol the steppers and ``Simulation`` rely on, for a
    frozen dataclass of tensors whose field names are ``FIELDS`` (a field
    set to ``None`` is skipped)."""

    FIELDS: ClassVar[tuple[str, ...]] = ()

    def items(self) -> Iterator[tuple[str, torch.Tensor]]:
        """(name, tensor) for each field that is set."""
        for name in self.FIELDS:
            val = getattr(self, name)
            if val is not None:
                yield name, val

    def map(self, fn, *others):
        """Apply ``fn`` field-wise over the fields set in ``self``."""
        return type(self)(**{
            name: fn(val, *(getattr(o, name) for o in others))
            for name, val in self.items()
        })

    @property
    def device(self) -> torch.device:
        return next(self.items())[1].device

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {name: val.detach().cpu().numpy() for name, val in self.items()}


@pytree_dataclass
class WeatherState(FieldState):
    """Prognostic state: velocity (u, v) and height h, plus the optional
    pressure p, temperature T, humidity q and surface pressure ps (``None``
    when unused)."""

    FIELDS: ClassVar[tuple[str, ...]] = STATE_FIELDS

    u: torch.Tensor
    v: torch.Tensor
    h: torch.Tensor
    p: Optional[torch.Tensor] = None
    T: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    ps: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, grid: GridSpec, device, dtype=torch.float32,
              full: bool = False) -> "WeatherState":
        """Rest state: h = 10 and, with ``full``, p = 1013.25, T = 288.15,
        q = 0 (the JAX package's defaults)."""
        def const(val):
            return torch.full(grid.shape, val, dtype=dtype, device=device)

        s = cls(u=const(0.0), v=const(0.0), h=const(10.0))
        if full:
            s = s.replace(p=const(1013.25), T=const(288.15), q=const(0.0))
        return s

    def astype(self, dtype) -> "WeatherState":
        """Every field that is set, converted to ``dtype``."""
        return self.map(lambda t: t.to(dtype))
