"""Climate risk assessment.

Counterpart of ``njw_tpu/geofinancial/climate.py``: the JAX package's
NumPy code, copied, on the port's ``geo_risk``.
"""
from __future__ import annotations

from enum import Enum
import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, SpatialRiskFactor, _normalize,
)
from njw_tpu_torch.geofinancial.geo_risk import IDENTITY_TRANSFORM


class ClimateHazardType(str, Enum):
    FLOODING = "flooding"
    HEATWAVE = "heatwave"
    SEA_LEVEL_RISE = "sea_level_rise"
    DROUGHT = "drought"
    WILDFIRE = "wildfire"
    STORM = "storm"


class TransitionRiskType(str, Enum):
    POLICY = "policy"
    TECHNOLOGY = "technology"
    MARKET = "market"
    REPUTATION = "reputation"


class ClimateScenario(str, Enum):
    """SSP-style scenarios (ref enum :45)."""

    OPTIMISTIC = "ssp1_26"
    MIDDLE = "ssp2_45"
    PESSIMISTIC = "ssp5_85"


class TimeHorizon(str, Enum):
    SHORT = "2030"
    MEDIUM = "2050"
    LONG = "2100"


# hazard intensity multipliers by (scenario, horizon) — scenario scaling
# used to project present-day hazard surfaces forward
_SCENARIO_SCALE = {
    (ClimateScenario.OPTIMISTIC, TimeHorizon.SHORT): 1.05,
    (ClimateScenario.OPTIMISTIC, TimeHorizon.MEDIUM): 1.1,
    (ClimateScenario.OPTIMISTIC, TimeHorizon.LONG): 1.15,
    (ClimateScenario.MIDDLE, TimeHorizon.SHORT): 1.1,
    (ClimateScenario.MIDDLE, TimeHorizon.MEDIUM): 1.3,
    (ClimateScenario.MIDDLE, TimeHorizon.LONG): 1.6,
    (ClimateScenario.PESSIMISTIC, TimeHorizon.SHORT): 1.2,
    (ClimateScenario.PESSIMISTIC, TimeHorizon.MEDIUM): 1.6,
    (ClimateScenario.PESSIMISTIC, TimeHorizon.LONG): 2.2,
}


def create_heatwave_risk_factor(land_surface_temp, weight: float = 1.0,
                                geo_transform=IDENTITY_TRANSFORM):
    """Hot areas are heatwave-risky (ref: climate_risk_assessment.py:700)."""
    return SpatialRiskFactor("heatwave_risk", weight,
                             _normalize(land_surface_temp), geo_transform,
                             "normalized land surface temperature")


def create_sea_level_rise_factor(dem, rise_m: float = 1.0,
                                 weight: float = 1.0,
                                 geo_transform=IDENTITY_TRANSFORM):
    """Cells below the projected rise are at full risk, tapering with
    elevation above it (ref: climate_risk_assessment.py:740)."""
    z = np.asarray(dem, np.float32)
    risk = np.clip(1.0 - (z - rise_m) / max(rise_m * 4.0, 1e-6), 0.0, 1.0)
    return SpatialRiskFactor("sea_level_rise", weight, risk, geo_transform,
                             f"inundation risk for {rise_m} m rise")


class ClimateRiskAssessor:
    """Physical + transition climate risk over a portfolio
    (ref: ClimateRiskAssessor, climate_risk_assessment.py:69)."""

    def __init__(self, scenario: ClimateScenario = ClimateScenario.MIDDLE,
                 horizon: TimeHorizon = TimeHorizon.MEDIUM):
        self.scenario = ClimateScenario(scenario)
        self.horizon = TimeHorizon(horizon)
        self.hazards: dict[ClimateHazardType, SpatialRiskFactor] = {}
        self.transition_weights: dict[TransitionRiskType, float] = {}

    @property
    def scale(self) -> float:
        return _SCENARIO_SCALE[(self.scenario, self.horizon)]

    def add_hazard(self, hazard: ClimateHazardType, rf: SpatialRiskFactor):
        self.hazards[ClimateHazardType(hazard)] = rf
        return self

    def set_transition_risk(self, kind: TransitionRiskType, weight: float):
        self.transition_weights[TransitionRiskType(kind)] = weight
        return self

    def physical_risk(self, portfolio: GeospatialPortfolio) -> dict:
        """Scenario-scaled hazard risk per asset (max over hazards)."""
        if not self.hazards:
            return {a.id: 0.0 for a in portfolio.assets}
        x, y = portfolio.coords()
        per_hazard = np.stack([rf.sample(x, y)
                               for rf in self.hazards.values()])
        combined = np.clip(per_hazard.max(axis=0) * self.scale, 0.0, 1.0)
        return {a.id: float(r) for a, r in zip(portfolio.assets, combined)}

    def transition_risk(self, portfolio: GeospatialPortfolio) -> dict:
        """Sector-based transition risk from asset metadata
        ('carbon_intensity' in [0,1])."""
        w = sum(self.transition_weights.values()) or 1.0
        out = {}
        for a in portfolio.assets:
            ci = float(a.metadata.get("carbon_intensity", 0.0))
            out[a.id] = min(ci * w * (self.scale - 1.0 + 0.5), 1.0)
        return out

    def combined_risk(self, portfolio: GeospatialPortfolio,
                      physical_weight: float = 0.6) -> dict:
        phys = self.physical_risk(portfolio)
        trans = self.transition_risk(portfolio)
        return {
            k: min(physical_weight * phys[k]
                   + (1 - physical_weight) * trans[k], 1.0)
            for k in phys
        }

    def expected_portfolio_loss(self, portfolio: GeospatialPortfolio) -> float:
        risks = self.combined_risk(portfolio)
        return float(sum(a.value * risks[a.id] for a in portfolio.assets))
