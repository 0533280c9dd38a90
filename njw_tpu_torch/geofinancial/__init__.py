"""Geospatial-financial risk: counterpart of ``njw_tpu.geofinancial``.

Spatial risk factors from DEM products (slope, flood), portfolio risk
assessment, risk aggregation and surfaces, climate risk, scenario
analysis, multi-region analysis, realtime streams, data connectors,
synthetic test data and batch planning; and the financial layer: risk
metrics with a Monte-Carlo VaR, portfolio optimisation with a wealth
simulation, options pricing with autograd Greeks. The JAX package has no
Pallas kernel here. The port runs on PyTorch's own operations on
``device`` (CUDA unless given): the DEM sweeps of the terrain factors,
the Monte-Carlo draws and their float32 products, the option prices,
Greeks and binomial tree. The rest is the JAX package's NumPy code,
copied. Random draws come from a ``torch.Generator`` on the device, so
they differ from JAX's; each Monte-Carlo function takes ``normals=`` to
replace its draw.
"""
from njw_tpu_torch.geofinancial.geo_risk import (
    SpatialRiskFactor, GeospatialRiskModel, GeospatialPortfolio,
    create_elevation_risk_factor, create_slope_risk_factor,
    create_flood_risk_factor,
)
from njw_tpu_torch.geofinancial.aggregation import (
    AggregationMethod, RiskAggregator, RiskSurfaceGenerator,
)
from njw_tpu_torch.geofinancial.climate import (
    ClimateHazardType, ClimateScenario, TimeHorizon, ClimateRiskAssessor,
    create_heatwave_risk_factor, create_sea_level_rise_factor,
)
from njw_tpu_torch.geofinancial.scenarios import (
    Scenario, ScenarioSet, ScenarioAnalyzer, create_climate_scenarios,
    create_economic_scenarios, create_stress_scenarios,
)
from njw_tpu_torch.geofinancial.data import (
    AssetLocationDataLoader, FinancialDataLoader, GeoRiskDataLoader,
    export_portfolio_geojson,
)
from njw_tpu_torch.geofinancial.testdata import (
    generate_assets, generate_dem, generate_returns, generate_dataset,
)
from njw_tpu_torch.geofinancial.multiregion import (
    RegionDefinition, RegionalPortfolio, MultiRegionRiskModel,
    RegionalRiskComparator,
)
from njw_tpu_torch.geofinancial.realtime import (
    DataStreamSource, MarketDataStream, GeospatialEventStream,
)
from njw_tpu_torch.geofinancial.optimizer import TPUOptimizer
from njw_tpu_torch.geofinancial.risk_metrics import (
    RiskMetricsAnalyzer, historical_var, parametric_var, monte_carlo_var,
    cvar, sharpe_ratio, sortino_ratio, max_drawdown, risk_attribution,
)
from njw_tpu_torch.geofinancial.portfolio import (
    PortfolioOptimizer, mean_variance_optimize, efficient_frontier,
    risk_parity, black_litterman, monte_carlo_simulation,
)
from njw_tpu_torch.geofinancial.options import (
    OptionsPricer, black_scholes, greeks, binomial_tree,
    monte_carlo_price, barrier_option_price, asian_option_price,
)
