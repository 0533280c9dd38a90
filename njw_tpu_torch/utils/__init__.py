"""Utilities (counterpart of ``njw_tpu.utils``).

  netcdf3.py     a pure-Python classic NetCDF-3 writer and reader
  checkpoint.py  save and load a state (or a Simulation) as one npz, in
                 the JAX package's file format
"""
