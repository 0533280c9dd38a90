"""Planar weather cores in PyTorch (counterpart of ``njw_tpu.weather``).

  grid.py         GridSpec, PhysicsParams, FieldState, WeatherState
  ics.py          registry of the 9 named initial conditions
  dynamics.py     SWE tendencies in plain torch (the "plain" path)
  barotropic.py   barotropic vorticity core (BarotropicState)
  primitive.py    primitive-equations core (PEState, sigma levels)
  integrators.py  euler / rk2 / rk4 / ab2 Steppers
  semi_implicit.py  semi-implicit SWE and PE steppers (spectral solves)
  staggered.py    Arakawa C-grid SWE core (Sadourny enstrophy form)
  nested.py       two-way nested refinement patch (NestedGrid, stepper)
  spherical.py    global spectral BVE and SWE cores (ops/sht.py)
  icosa.py        icosahedral 10-panel SWE core
  output.py       CSV / NPZ / NetCDF-3 / VTK snapshot writers
  model.py        SimConfig, Simulation step loop, PerformanceMetrics
  oracle.py       NumPy references of the three cores (the oracles)
  main_paths.py   each core's main path at full width (MAIN_PATHS,
                  GLOBAL_PATHS, ...)
  convert.py      carry states and parameters across from the JAX package
  __main__.py     CLI: python -m njw_tpu_torch.weather

Every weather configuration the JAX package's CLI accepts runs here.
"""
from njw_tpu_torch.weather.grid import (
    FieldState, GridSpec, PhysicsParams, WeatherState,
)
from njw_tpu_torch.weather.barotropic import BarotropicState
from njw_tpu_torch.weather.primitive import PEState
from njw_tpu_torch.weather.dynamics import diagnostics, make_tendency_fn
from njw_tpu_torch.weather.integrators import INTEGRATORS, make_stepper
from njw_tpu_torch.weather.ics import IC_REGISTRY, make_initial_state
from njw_tpu_torch.weather.model import SimConfig, Simulation
