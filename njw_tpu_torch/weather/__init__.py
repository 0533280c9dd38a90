"""Shallow-water weather core in PyTorch (counterpart of ``njw_tpu.weather``).

  grid.py         GridSpec, PhysicsParams, WeatherState
  ics.py          registry of the 9 named initial conditions
  dynamics.py     SWE tendencies in plain torch (the "plain" path)
  integrators.py  euler / rk2 / rk4 / ab2 Steppers
  model.py        SimConfig, Simulation step loop, PerformanceMetrics
  oracle.py       NumPy reference (the allclose oracle)
  convert.py      carry states and parameters across from the JAX package
  __main__.py     CLI: python -m njw_tpu_torch.weather

The barotropic and primitive-equation cores, the staggered, spherical and
icosahedral grids, nesting and the semi-implicit integrator are not yet
ported (ROADMAP).
"""
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.dynamics import diagnostics, make_tendency_fn
from njw_tpu_torch.weather.integrators import INTEGRATORS, make_stepper
from njw_tpu_torch.weather.ics import IC_REGISTRY, make_initial_state
from njw_tpu_torch.weather.model import SimConfig, Simulation
