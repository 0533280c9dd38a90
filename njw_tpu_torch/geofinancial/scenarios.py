"""Scenario analysis.

Counterpart of ``njw_tpu/geofinancial/scenarios.py``: the JAX package's
NumPy code, copied, on the port's ``geo_risk`` (scenarios, sets, the
analyzer with its analysis layer and JSON export, the climate, economic
and stress factories).
"""
from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass, field

import numpy as np

from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, GeospatialRiskModel,
)


@dataclass
class Scenario:
    """A named what-if: risk multiplier per factor name + value shocks per
    asset-class (ref: scenario_analysis.py:71)."""

    name: str
    description: str = ""
    risk_multipliers: dict = field(default_factory=dict)   # factor -> mult
    value_shocks: dict = field(default_factory=dict)       # class -> frac
    probability: float = 1.0


@dataclass
class ScenarioSet:
    """ref: scenario_analysis.py:229."""

    name: str
    scenarios: list = field(default_factory=list)

    def add(self, s: Scenario):
        self.scenarios.append(s)
        return self

    def normalized_probabilities(self) -> np.ndarray:
        p = np.asarray([s.probability for s in self.scenarios], np.float64)
        return p / max(p.sum(), 1e-12)


class ScenarioAnalyzer:
    """Evaluate portfolio loss under each scenario
    (ref: ScenarioAnalyzer, scenario_analysis.py:332)."""

    def __init__(self, portfolio: GeospatialPortfolio,
                 model: GeospatialRiskModel):
        self.portfolio = portfolio
        self.model = model
        # name -> analyze_scenario() result, consumed by the analysis-
        # layer methods (ref: scenario_analysis.py:372 scenario_results).
        self.scenario_results: dict[str, dict] = {}

    def _scenario_risk(self, scenario: Scenario) -> np.ndarray:
        x, y = self.portfolio.coords()
        acc = np.zeros_like(x, dtype=np.float64)
        total_w = 0.0
        for rf in self.model.risk_factors:
            mult = scenario.risk_multipliers.get(rf.name, 1.0)
            acc += rf.risk_weight * np.clip(rf.sample(x, y) * mult, 0, 1)
            total_w += rf.risk_weight
        return acc / max(total_w, 1e-12)

    def evaluate(self, scenario: Scenario) -> dict:
        risks = self._scenario_risk(scenario)
        losses = []
        for a, r in zip(self.portfolio.assets, risks):
            shock = scenario.value_shocks.get(
                a.metadata.get("asset_class", "default"),
                scenario.value_shocks.get("default", 0.0))
            losses.append(a.value * min(float(r) + shock, 1.0))
        total = float(sum(losses))
        return {
            "scenario": scenario.name,
            "total_loss": total,
            "loss_fraction": total / max(self.portfolio.total_value, 1e-12),
            "mean_risk": float(risks.mean()),
            "max_risk": float(risks.max()),
        }

    def evaluate_set(self, sset: ScenarioSet) -> dict:
        results = [self.evaluate(s) for s in sset.scenarios]
        p = sset.normalized_probabilities()
        expected = float(sum(pi * r["total_loss"]
                             for pi, r in zip(p, results)))
        worst = max(results, key=lambda r: r["total_loss"])
        return {
            "set": sset.name,
            "results": results,
            "expected_loss": expected,
            "worst_case": worst["scenario"],
            "worst_loss": worst["total_loss"],
        }

    def var(self, sset: ScenarioSet, confidence: float = 0.95) -> float:
        """Scenario-weighted value at risk."""
        results = [self.evaluate(s)["total_loss"] for s in sset.scenarios]
        p = sset.normalized_probabilities()
        order = np.argsort(results)
        cum = np.cumsum(p[order])
        idx = np.searchsorted(cum, confidence)
        return float(results[order[min(idx, len(results) - 1)]])

    # -- analysis layer (ref: scenario_analysis.py:500-1030) -----------

    def analyze_scenario(self, scenario: Scenario) -> dict:
        """Full per-scenario result (statistics + economic impact),
        cached in scenario_results (ref: scenario_analysis.py:500
        analyze_scenario)."""
        risks = self._scenario_risk(scenario)
        base = self.evaluate(scenario)
        values = np.asarray([a.value for a in self.portfolio.assets],
                            np.float64)
        total = max(float(values.sum()), 1e-12)
        result = {
            "scenario": scenario.name,
            "description": scenario.description,
            "statistics": {
                "mean": float(risks.mean()),
                "std": float(risks.std()),
                "min": float(risks.min()),
                "max": float(risks.max()),
                "value_weighted_risk": float((values * risks).sum()
                                             / total),
            },
            "economic_impact": {
                "expected_loss": base["total_loss"],
                "el_ratio": base["loss_fraction"],
            },
            "asset_risks": {a.id: float(r) for a, r
                            in zip(self.portfolio.assets, risks)},
        }
        self.scenario_results[scenario.name] = result
        return result

    def compare_scenarios(self, scenario_names: list,
                          baseline_scenario: str = None) -> dict:
        """Per-scenario abs/rel deltas of every statistic and economic
        metric vs a baseline (ref: scenario_analysis.py:587)."""
        for name in scenario_names:
            if name not in self.scenario_results:
                raise ValueError(
                    f"Scenario '{name}' has not been analyzed yet")
        if baseline_scenario is None:
            baseline_scenario = scenario_names[0]
        elif baseline_scenario not in scenario_names:
            raise ValueError(
                f"Baseline scenario '{baseline_scenario}' not in list")
        base = self.scenario_results[baseline_scenario]

        def deltas(section: str) -> dict:
            out = {}
            for name in scenario_names:
                if name == baseline_scenario:
                    continue
                row = {}
                sc = self.scenario_results[name][section]
                for k in set(base[section]) & set(sc):
                    b, s = base[section][k], sc[k]
                    row[k] = {
                        "baseline": b, "scenario": s,
                        "abs_diff": s - b,
                        "rel_diff": (s - b) / b if b != 0
                        else float("inf"),
                    }
                out[name] = row
            return out

        return {
            "scenarios": list(scenario_names),
            "baseline": baseline_scenario,
            "statistics_comparison": deltas("statistics"),
            "economic_comparison": deltas("economic_impact"),
        }

    def perform_sensitivity_analysis(self, risk_factor_name: str,
                                     multipliers,
                                     scenario_template: Scenario = None
                                     ) -> dict:
        """Sweep one factor's risk multiplier, analyze each point, and
        return the response curves (ref: scenario_analysis.py:796; the
        parameter being varied is the factor's multiplier — the njw
        Scenario's native modifier)."""
        template = scenario_template or Scenario("sensitivity", "")
        names = []
        for m in multipliers:
            mult = dict(template.risk_multipliers)
            mult[risk_factor_name] = float(m)
            s = Scenario(f"{template.name}_{risk_factor_name}_{m:g}",
                         f"{template.description} "
                         f"[{risk_factor_name} x {m:g}]",
                         mult, dict(template.value_shocks),
                         template.probability)
            self.analyze_scenario(s)
            names.append(s.name)
        rows = [self.scenario_results[n] for n in names]
        return {
            "parameter": risk_factor_name,
            "values": [float(m) for m in multipliers],
            "scenarios": names,
            "mean_risks": [r["statistics"]["mean"] for r in rows],
            "weighted_risks": [r["statistics"]["value_weighted_risk"]
                               for r in rows],
            "expected_losses": [r["economic_impact"]["expected_loss"]
                                for r in rows],
            "comparison": self.compare_scenarios(names, names[0]),
        }

    @staticmethod
    def combine_scenarios(scenarios: list, name: str = None) -> Scenario:
        """Compose scenarios: risk multipliers multiply, value shocks
        compose as 1 - prod(1 - s) (both stay monotone and bounded;
        ref: scenario_analysis.py:908-955 merges modifier lists)."""
        mult: dict = {}
        shock_keep: dict = {}
        for s in scenarios:
            for k, m in s.risk_multipliers.items():
                mult[k] = mult.get(k, 1.0) * m
            for k, v in s.value_shocks.items():
                shock_keep[k] = shock_keep.get(k, 1.0) * (1.0 - v)
        shocks = {k: 1.0 - keep for k, keep in shock_keep.items()}
        return Scenario(
            name or "combo_" + "_".join(s.name for s in scenarios),
            "combined: " + ", ".join(s.name for s in scenarios),
            mult, shocks, 1.0)

    def perform_stress_test(self, stress_scenarios: list,
                            combination_levels: int = 1) -> dict:
        """Analyze a baseline, each stress scenario, and (optionally)
        their k-way combinations; compare all to baseline
        (ref: scenario_analysis.py:877)."""
        baseline = Scenario("baseline", "stress-test baseline")
        self.analyze_scenario(baseline)
        for s in stress_scenarios:
            self.analyze_scenario(s)
        combo_names = []
        for level in range(2, min(combination_levels,
                                  len(stress_scenarios)) + 1):
            for combo in itertools.combinations(stress_scenarios, level):
                c = self.combine_scenarios(list(combo))
                self.analyze_scenario(c)
                combo_names.append(c.name)
        all_names = (["baseline"] + [s.name for s in stress_scenarios]
                     + combo_names)
        metrics = {
            name: {
                "mean_risk":
                    self.scenario_results[name]["statistics"]["mean"],
                "value_weighted_risk":
                    self.scenario_results[name]["statistics"]
                    ["value_weighted_risk"],
                "expected_loss":
                    self.scenario_results[name]["economic_impact"]
                    ["expected_loss"],
                "el_ratio":
                    self.scenario_results[name]["economic_impact"]
                    ["el_ratio"],
            }
            for name in all_names
        }
        return {
            "baseline": "baseline",
            "scenarios": [s.name for s in stress_scenarios],
            "combinations": combo_names,
            "metrics": metrics,
            "comparison": self.compare_scenarios(all_names, "baseline"),
        }

    def export_results(self, output_path: str) -> str:
        """Serialize all analyzed scenarios to JSON, per-asset detail
        dropped for size (ref: scenario_analysis.py:999)."""
        parent = os.path.dirname(output_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        export = {
            name: {k: v for k, v in res.items() if k != "asset_risks"}
            for name, res in self.scenario_results.items()
        }
        with open(output_path, "w") as fh:
            json.dump(export, fh, indent=2)
        return output_path


def create_climate_scenarios() -> ScenarioSet:
    """ref: scenario_analysis.py:1786."""
    return ScenarioSet("climate", [
        Scenario("baseline", "current climate", {}, {}, 0.5),
        Scenario("2c_warming", "moderate warming",
                 {"flood_risk": 1.3, "heatwave_risk": 1.4}, {}, 0.3),
        Scenario("4c_warming", "severe warming",
                 {"flood_risk": 1.8, "heatwave_risk": 2.0,
                  "sea_level_rise": 1.6}, {"coastal": 0.1}, 0.2),
    ])


def create_economic_scenarios() -> ScenarioSet:
    """ref: scenario_analysis.py:1880."""
    return ScenarioSet("economic", [
        Scenario("expansion", "growth", {}, {"default": -0.05}, 0.4),
        Scenario("recession", "downturn", {}, {"default": 0.15}, 0.4),
        Scenario("crisis", "financial crisis", {},
                 {"default": 0.35, "real_estate": 0.45}, 0.2),
    ])


def create_stress_scenarios() -> ScenarioSet:
    """ref: scenario_analysis.py:1940."""
    return ScenarioSet("stress", [
        Scenario("combined_stress", "climate + economic stress",
                 {"flood_risk": 2.0, "heatwave_risk": 1.8},
                 {"default": 0.25}, 1.0),
    ])
