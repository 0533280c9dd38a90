"""Carry portfolios, risk factors and models, scenario sets and regions
across from the JAX package and back.

Both packages keep these as Python objects over NumPy arrays and floats,
so a JAX object (or a dict with its fields) is read field by field and
this module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, GeospatialRiskModel, SpatialRiskFactor,
)
from njw_tpu_torch.geofinancial.multiregion import RegionDefinition
from njw_tpu_torch.geofinancial.scenarios import Scenario, ScenarioSet
from njw_tpu_torch.geospatial.convert import (
    geo_transform_fields, geo_transform_from,
)

_ASSET_FIELDS = ("id", "name", "value", "x", "y")
_REGION_FIELDS = ("name", "x_min", "x_max", "y_min", "y_max")


def _get(other, key, default=None):
    if isinstance(other, dict):
        return other.get(key, default)
    return getattr(other, key, default)


def portfolio_from(other: Any) -> GeospatialPortfolio:
    """The port's portfolio with copies of ``other``'s assets: id, name,
    value, coordinates, metadata and return history."""
    port = GeospatialPortfolio()
    for a in _get(other, "assets"):
        r = _get(a, "returns")
        port.add_asset(*(_get(a, f) for f in _ASSET_FIELDS),
                       metadata=dict(_get(a, "metadata") or {}),
                       returns=None if r is None else np.array(r, np.float64))
    return port


def portfolio_fields(port: GeospatialPortfolio) -> dict:
    """A port portfolio as a dict of the JAX one's fields (its assets as
    dicts of theirs)."""
    return {"assets": [
        {**{f: getattr(a, f) for f in _ASSET_FIELDS},
         "metadata": dict(a.metadata),
         "returns": None if a.returns is None else a.returns.copy()}
        for a in port.assets]}


def risk_factor_from(other: Any) -> SpatialRiskFactor:
    """The port's factor: name, weight, a copy of the surface and the six
    ``GeoTransform`` numbers."""
    return SpatialRiskFactor(
        _get(other, "name"), float(_get(other, "risk_weight")),
        np.array(_get(other, "risk_data"), np.float32),
        geo_transform_from(_get(other, "geo_transform")),
        _get(other, "description", ""))


def risk_factor_fields(rf: SpatialRiskFactor) -> dict:
    """A port factor as a dict of the JAX one's fields (its transform as
    a dict of six numbers)."""
    return {"name": rf.name, "risk_weight": rf.risk_weight,
            "risk_data": rf.risk_data.copy(),
            "geo_transform": geo_transform_fields(rf.geo_transform),
            "description": rf.description}


def risk_model_from(other: Any) -> GeospatialRiskModel:
    """The port's model over copies of ``other``'s factors."""
    return GeospatialRiskModel([risk_factor_from(rf)
                                for rf in _get(other, "risk_factors")])


def scenario_set_from(other: Any) -> ScenarioSet:
    """The port's scenario set: names, descriptions, multipliers, shocks
    and probabilities."""
    return ScenarioSet(_get(other, "name"), [
        Scenario(_get(s, "name"), _get(s, "description", ""),
                 dict(_get(s, "risk_multipliers") or {}),
                 dict(_get(s, "value_shocks") or {}),
                 float(_get(s, "probability", 1.0)))
        for s in _get(other, "scenarios")])


def region_from(other: Any) -> RegionDefinition:
    """The port's region with ``other``'s name, bounds and metadata."""
    return RegionDefinition(*(_get(other, f) for f in _REGION_FIELDS),
                            dict(_get(other, "metadata") or {}))
