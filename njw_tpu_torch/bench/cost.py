"""Cost models: runtime to money.

Counterpart of ``njw_tpu/bench/cost.py``, pure Python, the same classes
and numbers: an amortised on-premises node (capital, power, maintenance),
cloud accelerator instances (TPU chips, GPUs) at an hourly rate with an
optional spot discount, a shared cluster's charge-back and a local CPU's
power. ``load_cost_model`` builds one from ``configs/*.yaml``
(``environment:`` plus the model's fields; ``configs/cloud_gpu_h100.yaml``
prices the H100). The defaults are list-price ballparks, not
measurements.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional


class ComputeEnvironment(str, Enum):
    ON_PREM_TPU = "on_prem_tpu"
    CLOUD_TPU = "cloud_tpu"
    CLOUD_GPU = "cloud_gpu"
    SLURM_CLUSTER = "slurm_cluster"
    LOCAL_CPU = "local_cpu"


@dataclass
class CostModel:
    """Base: converts runtime to money."""

    name: str = "base"
    currency: str = "USD"

    def hourly_rate(self) -> float:
        raise NotImplementedError

    def fixed_cost(self) -> float:
        """Upfront capital (0 for pure pay-as-you-go models). Break-even
        analysis is only meaningful between models whose fixed/variable
        structures differ."""
        return 0.0

    def variable_hourly_rate(self) -> float:
        """Marginal $/hour once the fixed cost is sunk (== hourly_rate for
        pay-as-you-go models)."""
        return self.hourly_rate()

    def cost_of(self, seconds: float) -> dict:
        rate = self.hourly_rate()
        cost = rate * seconds / 3600.0
        return {
            "model": self.name,
            "hourly_rate": rate,
            "execution_cost": cost,
            "currency": self.currency,
        }

    def cost_per_throughput(self, seconds: float, work: float) -> float:
        """Cost per unit of work."""
        return self.cost_of(seconds)["execution_cost"] / max(work, 1e-12)


@dataclass
class OnPremTPUCostModel(CostModel):
    """Amortized on-prem accelerator node ($/node, W, amortization
    months, utilization)."""

    name: str = "on_prem_tpu"
    node_cost: float = 10000.0
    nodes: int = 1
    power_watts: float = 300.0
    power_cost_per_kwh: float = 0.12
    amortization_months: float = 36.0
    utilization: float = 0.7
    maintenance_factor: float = 0.1

    def hourly_rate(self) -> float:
        hours = self.amortization_months * 30 * 24 * self.utilization
        capital = self.node_cost * self.nodes * (
            1 + self.maintenance_factor) / hours
        return capital + self.variable_hourly_rate()

    def fixed_cost(self) -> float:
        return self.node_cost * self.nodes * (1 + self.maintenance_factor)

    def variable_hourly_rate(self) -> float:
        return self.power_watts * self.nodes / 1000.0 \
            * self.power_cost_per_kwh


@dataclass
class CloudTPUCostModel(CostModel):
    """Cloud TPU on-demand pricing per chip-hour."""

    name: str = "cloud_tpu"
    chip_type: str = "v5e"
    chips: int = 1
    rate_per_chip_hour: float = 1.20
    spot_discount: float = 0.0  # 0..1

    def hourly_rate(self) -> float:
        return self.rate_per_chip_hour * self.chips * (1 - self.spot_discount)


@dataclass
class CloudGPUCostModel(CostModel):
    """Cloud GPU instance pricing per GPU-hour."""

    name: str = "cloud_gpu"
    instance_type: str = "a100"
    gpus: int = 1
    rate_per_gpu_hour: float = 3.67
    spot_discount: float = 0.0

    def hourly_rate(self) -> float:
        return self.rate_per_gpu_hour * self.gpus * (1 - self.spot_discount)


@dataclass
class SlurmClusterCostModel(CostModel):
    """Shared-cluster charge-back."""

    name: str = "slurm_cluster"
    cost_per_node_hour: float = 2.0
    nodes: int = 1
    queue_overhead_factor: float = 1.1

    def hourly_rate(self) -> float:
        return self.cost_per_node_hour * self.nodes \
            * self.queue_overhead_factor


@dataclass
class LocalCPUCostModel(CostModel):
    name: str = "local_cpu"
    power_watts: float = 150.0
    power_cost_per_kwh: float = 0.12

    def hourly_rate(self) -> float:
        return self.power_watts / 1000.0 * self.power_cost_per_kwh


class CostModelFactory:
    """Builds a model by environment name."""

    _MODELS = {
        ComputeEnvironment.ON_PREM_TPU: OnPremTPUCostModel,
        ComputeEnvironment.CLOUD_TPU: CloudTPUCostModel,
        ComputeEnvironment.CLOUD_GPU: CloudGPUCostModel,
        ComputeEnvironment.SLURM_CLUSTER: SlurmClusterCostModel,
        ComputeEnvironment.LOCAL_CPU: LocalCPUCostModel,
    }

    @classmethod
    def create(cls, environment, **kw) -> CostModel:
        env = ComputeEnvironment(environment)
        return cls._MODELS[env](**kw)

    @classmethod
    def available(cls) -> list[str]:
        return [e.value for e in cls._MODELS]


def compare_costs(seconds_per_env: dict, models: Optional[dict] = None,
                  work: float = 1.0) -> dict:
    """Cross-environment comparison incl. break-even hours between the
    cheapest two."""
    models = models or {
        env: CostModelFactory.create(env) for env in (
            ComputeEnvironment.ON_PREM_TPU, ComputeEnvironment.CLOUD_TPU)
    }
    rows = {}
    for env, seconds in seconds_per_env.items():
        model = models[env] if env in models else CostModelFactory.create(env)
        c = model.cost_of(seconds)
        c["cost_per_work_unit"] = c["execution_cost"] / max(work, 1e-12)
        rows[str(getattr(env, "value", env))] = c
    ranked = sorted(rows.items(), key=lambda kv: kv[1]["execution_cost"])
    out = {"environments": rows, "cheapest": ranked[0][0]}
    if len(ranked) >= 2:
        out["break_even_hours"] = break_even_hours(
            _model_for(ranked[0][0], models),
            _model_for(ranked[1][0], models))
    return out


def _model_for(env_name: str, models: Optional[dict]) -> CostModel:
    if models:
        for k, m in models.items():
            if str(getattr(k, "value", k)) == env_name:
                return m
    return CostModelFactory.create(env_name)


def break_even_hours(a: CostModel, b: CostModel) -> Optional[float]:
    """Hours of use at which cumulative costs (fixed + variable*t) of two
    models cross. None when the structures never cross — e.g. two pure
    hourly-rate models, where a negative 'break-even' would be meaningless.
    The model with the larger fixed cost must have the lower
    variable rate for a crossover to exist."""
    if a.fixed_cost() < b.fixed_cost():
        a, b = b, a  # a: high-fixed candidate
    d_fixed = a.fixed_cost() - b.fixed_cost()
    d_rate = b.variable_hourly_rate() - a.variable_hourly_rate()
    if d_fixed <= 0.0 or d_rate <= 0.0:
        return None
    return d_fixed / d_rate


def load_cost_model(path: str, **overrides) -> CostModel:
    """Build a cost model from a YAML/JSON config (configs/*.yaml). The
    file holds `environment:` plus the model's dataclass fields; unknown
    keys raise."""
    import dataclasses

    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
    else:
        import json

        with open(path) as fh:
            data = json.load(fh)
    data.update(overrides)
    env = data.pop("environment", None)
    if env is None:
        raise ValueError(f"{path}: missing 'environment' key "
                         f"(one of {CostModelFactory.available()})")
    cls = CostModelFactory._MODELS[ComputeEnvironment(env)]
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"{path}: unknown keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    return cls(**data)
