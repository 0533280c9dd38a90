"""Geo-financial views: counterpart of ``njw_tpu/viz/geofinancial.py``
(risk maps, portfolio maps, risk distributions, scenario comparisons,
sensitivity and stress views, the multi-region views, their facades
``ScenarioVisualizer`` and ``MultiRegionVisualizer``, and an HTML
report).

The models are the port's (``njw_tpu_torch.geofinancial``); their risk
surfaces are host arrays, and any tensor input (returns) is copied to
the host. The views draw with matplotlib and raise its ImportError where
it is missing; ``generate_geofin_report`` then writes its page with the
tables and no images.
"""
from __future__ import annotations

import html
import os
import tempfile
from typing import Optional

import numpy as np

from njw_tpu_torch.viz._common import have_matplotlib, pyplot, to_numpy


def plot_risk_map(model, path: str, *, shape=(256, 256), extent=None,
                  portfolio=None) -> str:
    """Combined risk surface with optional asset overlay (value-sized)."""
    plt = pyplot()
    if model.risk_factors:
        h0, w0 = model.risk_factors[0].risk_data.shape
    else:
        h0, w0 = shape
    ys = np.linspace(0, h0 - 1, shape[0])
    xs = np.linspace(0, w0 - 1, shape[1])
    gx, gy = np.meshgrid(xs, ys)
    grid = model.assess_risk(gx.ravel(), gy.ravel()).reshape(shape)
    fig, ax = plt.subplots(figsize=(6.5, 5))
    im = ax.imshow(grid, cmap="YlOrRd", origin="lower", vmin=0, vmax=1,
                   extent=extent)
    fig.colorbar(im, ax=ax, label="combined risk")
    if portfolio is not None:
        vals = to_numpy([a.value for a in portfolio.assets])
        sizes = 10 + 90 * vals / max(vals.max(), 1e-12)
        ax.scatter([a.x for a in portfolio.assets],
                   [a.y for a in portfolio.assets], s=sizes,
                   facecolor="white", edgecolor="black", alpha=0.8,
                   label="assets")
        ax.legend(loc="upper right")
    ax.set_title("risk map")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_portfolio_map(portfolio, risks: dict, path: str) -> str:
    """Assets colored by risk, sized by value (ref portfolio map)."""
    plt = pyplot()
    xs = [a.x for a in portfolio.assets]
    ys = [a.y for a in portfolio.assets]
    vals = to_numpy([a.value for a in portfolio.assets])
    r = to_numpy([risks.get(a.id, 0.0) for a in portfolio.assets])
    fig, ax = plt.subplots(figsize=(6.5, 5))
    sc = ax.scatter(xs, ys, c=r, s=10 + 140 * vals / vals.max(),
                    cmap="RdYlGn_r", vmin=0, vmax=1, edgecolor="k",
                    linewidth=0.4)
    fig.colorbar(sc, ax=ax, label="asset risk")
    ax.set_title("portfolio")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_risk_distribution(risks: dict, path: str, *, bins: int = 20) -> str:
    plt = pyplot()
    vals = to_numpy(list(risks.values()), np.float64)
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.hist(vals, bins=bins, range=(0, 1), color="#c0504d",
            edgecolor="white")
    ax.axvline(vals.mean(), color="k", linestyle="--",
               label=f"mean {vals.mean():.2f}")
    ax.set_xlabel("risk")
    ax.set_ylabel("assets")
    ax.set_title("risk distribution")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_scenario_comparison(results: list[dict], path: str) -> str:
    """Horizontal loss bars per scenario (ScenarioAnalyzer.evaluate rows)."""
    plt = pyplot()
    names = [r["scenario"] for r in results]
    losses = [r["total_loss"] for r in results]
    fig, ax = plt.subplots(figsize=(6.5, 0.5 + 0.45 * len(names)))
    ax.barh(names, losses, color="#4878cf")
    ax.set_xlabel("total loss (USD)")
    ax.set_title("scenario losses")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_returns(returns, path: str, *, max_series: int = 12) -> str:
    """Cumulative return paths (ref financial time-series view)."""
    plt = pyplot()
    r = to_numpy(returns, np.float64)
    if r.ndim == 1:
        r = r[:, None]
    cum = np.cumprod(1.0 + r[:, :max_series], axis=0)
    fig, ax = plt.subplots(figsize=(6.5, 3.5))
    ax.plot(cum, linewidth=0.9)
    ax.axhline(1.0, color="#999", linewidth=0.7)
    ax.set_xlabel("day")
    ax.set_ylabel("growth of $1")
    ax.set_title("asset returns")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_sensitivity_analysis(analyzer, path: str, *,
                              multipliers=None) -> str:
    """Loss vs risk-factor multiplier, one curve per factor — consumes
    ScenarioAnalyzer.perform_sensitivity_analysis (the data API), it no
    longer embeds the math (ref:
    ScenarioVisualizer.plot_sensitivity_analysis,
    scenario_analysis.py:1034+)."""
    plt = pyplot()
    ms = to_numpy(multipliers if multipliers is not None
                    else np.linspace(0.5, 2.0, 7))
    fig, ax = plt.subplots(figsize=(6.5, 4))
    for rf in analyzer.model.risk_factors:
        sens = analyzer.perform_sensitivity_analysis(rf.name, ms)
        ax.plot(sens["values"], sens["expected_losses"], marker="o",
                label=rf.name)
    ax.set_xlabel("risk multiplier")
    ax.set_ylabel("total loss (USD)")
    ax.set_title("sensitivity analysis")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_stress_test_results(results: list[dict], path: str, *,
                             baseline: Optional[dict] = None) -> str:
    """Stress losses as % of portfolio value, vs an optional baseline
    (ref: ScenarioVisualizer.plot_stress_test_results)."""
    plt = pyplot()
    names = [r["scenario"] for r in results]
    fracs = [100.0 * r["loss_fraction"] for r in results]
    fig, ax = plt.subplots(figsize=(6.5, 0.7 + 0.5 * len(names)))
    ax.barh(names, fracs, color="#d65f5f", label="stressed")
    if baseline is not None:
        ax.axvline(100.0 * baseline["loss_fraction"], color="k",
                   linestyle="--",
                   label=f"baseline ({baseline['scenario']})")
        ax.legend()
    ax.set_xlabel("loss (% of portfolio value)")
    ax.set_title("stress test")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def create_scenario_dashboard(analyzer, sset, path: str) -> str:
    """2x2 panel: scenario losses, economic impact (loss fraction),
    sensitivity curves, per-asset risk distribution under the worst case
    (ref: ScenarioVisualizer.create_scenario_dashboard)."""
    plt = pyplot()
    agg = analyzer.evaluate_set(sset)
    results = agg["results"]
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    names = [r["scenario"] for r in results]
    axes[0, 0].barh(names, [r["total_loss"] for r in results],
                    color="#4878cf")
    axes[0, 0].set_title("scenario losses (USD)")
    axes[0, 1].barh(names, [100.0 * r["loss_fraction"] for r in results],
                    color="#e49444")
    axes[0, 1].set_title("economic impact (% of value)")
    ms = np.linspace(0.5, 2.0, 7)
    for rf in analyzer.model.risk_factors:
        sens = analyzer.perform_sensitivity_analysis(rf.name, ms)
        axes[1, 0].plot(sens["values"], sens["expected_losses"],
                        marker="o", label=rf.name)
    axes[1, 0].set_title("sensitivity")
    axes[1, 0].set_xlabel("risk multiplier")
    axes[1, 0].legend(fontsize=8)
    worst = max(sset.scenarios,
                key=lambda s: analyzer.evaluate(s)["total_loss"])
    axes[1, 1].hist(analyzer._scenario_risk(worst), bins=20, range=(0, 1),
                    color="#c0504d", edgecolor="white")
    axes[1, 1].set_title(f"asset risks under '{worst.name}'")
    fig.suptitle(f"scenario dashboard: {sset.name}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


class ScenarioVisualizer:
    """Facade mirroring the reference class
    (ref: scenario_analysis.py:1034 ScenarioVisualizer)."""

    def __init__(self, analyzer):
        self.analyzer = analyzer

    def plot_scenario_comparison(self, sset, path: str) -> str:
        agg = self.analyzer.evaluate_set(sset)
        return plot_scenario_comparison(agg["results"], path)

    def plot_sensitivity_analysis(self, path: str, **kw) -> str:
        return plot_sensitivity_analysis(self.analyzer, path, **kw)

    def plot_stress_test_results(self, sset, path: str, *,
                                 baseline=None) -> str:
        results = [self.analyzer.evaluate(s) for s in sset.scenarios]
        base = self.analyzer.evaluate(baseline) if baseline else None
        return plot_stress_test_results(results, path, baseline=base)

    def create_scenario_dashboard(self, sset, path: str) -> str:
        return create_scenario_dashboard(self.analyzer, sset, path)


# ---------------------------------------------------------------------------
# Multi-region views (ref: multiregion_analysis.py:964 MultiRegionVisualizer)
# ---------------------------------------------------------------------------

def plot_multi_region_risk_map(mr_model, portfolio, path: str) -> str:
    """Region rectangles shaded by mean risk with the asset overlay
    (ref: MultiRegionVisualizer.plot_multi_region_risk_map)."""
    plt = pyplot()
    import matplotlib as mpl
    import matplotlib.patches as mpatches

    summary = mr_model.assess(portfolio)
    fig, ax = plt.subplots(figsize=(7, 5.5))
    cmap = mpl.colormaps["YlOrRd"]
    for name, region in mr_model.regions.items():
        risk = summary.get(name, {}).get("mean_risk", 0.0)
        ax.add_patch(mpatches.Rectangle(
            (region.x_min, region.y_min),
            region.x_max - region.x_min, region.y_max - region.y_min,
            facecolor=cmap(risk), edgecolor="#555", alpha=0.75))
        ax.text(0.5 * (region.x_min + region.x_max),
                0.5 * (region.y_min + region.y_max),
                f"{name}\n{risk:.2f}", ha="center", va="center",
                fontsize=8)
    vals = to_numpy([a.value for a in portfolio.assets])
    ax.scatter([a.x for a in portfolio.assets],
               [a.y for a in portfolio.assets],
               s=8 + 60 * vals / max(vals.max(), 1e-12),
               facecolor="white", edgecolor="black", zorder=3)
    ax.autoscale_view()
    ax.set_title("multi-region risk map")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_region_risk_comparison(summary: dict, path: str) -> str:
    """Mean risk and expected loss per region, twin-axis bars
    (ref: MultiRegionVisualizer.plot_region_risk_comparison)."""
    plt = pyplot()
    names = [n for n in summary if not n.startswith("_")]
    risk = [summary[n]["mean_risk"] for n in names]
    loss = [summary[n]["expected_loss"] for n in names]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(x - 0.2, risk, width=0.4, color="#4878cf", label="mean risk")
    ax.set_ylabel("mean risk", color="#4878cf")
    ax.set_ylim(0, 1)
    ax2 = ax.twinx()
    ax2.bar(x + 0.2, loss, width=0.4, color="#d65f5f",
            label="expected loss")
    ax2.set_ylabel("expected loss (USD)", color="#d65f5f")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_title("region risk comparison")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_risk_correlation_matrix(mr_model, portfolio, path: str) -> str:
    """Correlation of per-asset risk between the region models, evaluated
    over the full asset set (ref:
    MultiRegionVisualizer.plot_risk_correlation_matrix)."""
    plt = pyplot()
    x, y = portfolio.coords()
    names = list(mr_model.region_models)
    risks = np.stack([
        to_numpy(mr_model.region_models[n].assess_risk(x, y), np.float64)
        for n in names
    ])
    c = np.corrcoef(risks) if len(names) > 1 else np.ones((1, 1))
    c = np.nan_to_num(c, nan=0.0)
    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    im = ax.imshow(c, cmap="RdBu_r", vmin=-1, vmax=1)
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(names, fontsize=8)
    for i in range(len(names)):
        for j in range(len(names)):
            ax.text(j, i, f"{c[i, j]:.2f}", ha="center", va="center",
                    fontsize=7)
    fig.colorbar(im, ax=ax, label="risk correlation")
    ax.set_title("region risk correlation")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_recommended_allocation(mr_model, portfolio, path: str) -> str:
    """Inverse-risk-weighted target allocation vs current value share
    (ref: MultiRegionVisualizer.plot_recommended_allocation)."""
    plt = pyplot()
    summary = mr_model.assess(portfolio)
    names = [n for n in summary if not n.startswith("_")]
    value = to_numpy([summary[n]["total_value"] for n in names],
                       np.float64)
    risk = to_numpy([summary[n]["mean_risk"] for n in names], np.float64)
    current = value / max(value.sum(), 1e-12)
    inv = 1.0 / np.maximum(risk, 1e-3)
    target = inv / inv.sum()
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(x - 0.2, 100 * current, width=0.4, color="#999",
           label="current")
    ax.bar(x + 0.2, 100 * target, width=0.4, color="#59a14f",
           label="recommended (inverse-risk)")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("allocation (%)")
    ax.set_title("recommended allocation")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def create_multi_region_dashboard(mr_model, portfolio, path: str) -> str:
    """2x2 panel of the four multi-region views in one figure
    (ref: MultiRegionVisualizer.create_multi_region_dashboard)."""
    plt = pyplot()
    import matplotlib.image as mpimg

    with tempfile.TemporaryDirectory() as td:
        panels = [
            plot_multi_region_risk_map(mr_model, portfolio,
                                       os.path.join(td, "a.png")),
            plot_region_risk_comparison(mr_model.assess(portfolio),
                                        os.path.join(td, "b.png")),
            plot_risk_correlation_matrix(mr_model, portfolio,
                                         os.path.join(td, "c.png")),
            plot_recommended_allocation(mr_model, portfolio,
                                        os.path.join(td, "d.png")),
        ]
        fig, axes = plt.subplots(2, 2, figsize=(13, 10))
        for ax, p in zip(axes.ravel(), panels):
            ax.imshow(mpimg.imread(p))
            ax.axis("off")
        fig.suptitle("multi-region dashboard")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return path


class MultiRegionVisualizer:
    """Facade mirroring the reference class
    (ref: multiregion_analysis.py:964 MultiRegionVisualizer)."""

    def __init__(self, mr_model):
        self.model = mr_model

    def plot_multi_region_risk_map(self, portfolio, path: str) -> str:
        return plot_multi_region_risk_map(self.model, portfolio, path)

    def plot_region_risk_comparison(self, portfolio, path: str) -> str:
        return plot_region_risk_comparison(self.model.assess(portfolio),
                                           path)

    def plot_risk_correlation_matrix(self, portfolio, path: str) -> str:
        return plot_risk_correlation_matrix(self.model, portfolio, path)

    def plot_recommended_allocation(self, portfolio, path: str) -> str:
        return plot_recommended_allocation(self.model, portfolio, path)

    def create_multi_region_dashboard(self, portfolio, path: str) -> str:
        return create_multi_region_dashboard(self.model, portfolio, path)


def generate_geofin_report(output_dir: str, portfolio, model, *,
                           scenarios=None, returns=None) -> str:
    """Every applicable view and an HTML index (the static-report
    counterpart of the live dashboard). Without matplotlib the index holds
    the tables alone."""
    os.makedirs(output_dir, exist_ok=True)
    j = os.path.join
    draw = have_matplotlib()
    risks = portfolio.assess_risk(model)
    plots = []
    if draw:
        plots = [
            plot_risk_map(model, j(output_dir, "risk_map.png"),
                          portfolio=portfolio),
            plot_portfolio_map(portfolio, risks,
                               j(output_dir, "portfolio.png")),
            plot_risk_distribution(risks, j(output_dir, "distribution.png")),
        ]
    rows = ""
    if scenarios is not None:
        from njw_tpu_torch.geofinancial.scenarios import ScenarioAnalyzer

        analyzer = ScenarioAnalyzer(portfolio, model)
        agg = analyzer.evaluate_set(scenarios)
        if draw:
            plots.append(plot_scenario_comparison(
                agg["results"], j(output_dir, "scenarios.png")))
        rows = (f"<tr><td>expected loss</td>"
                f"<td>{agg['expected_loss']:,.0f}</td></tr>"
                f"<tr><td>worst case</td>"
                f"<td>{html.escape(agg['worst_case'])}</td></tr>")
    if returns is not None and draw:
        plots.append(plot_returns(returns, j(output_dir, "returns.png")))
    total = portfolio.total_value
    vals = np.asarray(list(risks.values()))
    rows = (f"<tr><td>total value</td><td>{total:,.0f}</td></tr>"
            f"<tr><td>mean risk</td><td>{vals.mean():.3f}</td></tr>"
            + rows)
    imgs = "".join(f'<img src="{os.path.basename(p)}" '
                   'style="max-width:48%">' for p in plots)
    page = ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>geo-financial report</title></head><body>"
            "<h1>geo-financial report</h1>"
            f"<table border=1>{rows}</table>{imgs}</body></html>")
    out = j(output_dir, "index.html")
    with open(out, "w") as fh:
        fh.write(page)
    return out
