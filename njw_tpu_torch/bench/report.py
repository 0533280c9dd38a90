"""Benchmark reports: PNG charts and one HTML page.

Counterpart of ``njw_tpu/bench/report.py``, the same generators:

  plot_execution_time / plot_throughput / plot_memory
  plot_energy            (when energy_joules is in the metrics)
  plot_device_utilization(when duty_factor is in the metrics)
  plot_cost_comparison   (execution cost of each workload per environment)
  plot_cost_per_op       (cost per unit of work per environment)
  plot_break_even        (cumulative-cost curves + crossover marker)
  plot_scaling           (throughput vs devices + ideal line)
  plot_scaling_efficiency(efficiency bars per device count)
  environment_table      (per-workload cost in each environment)
  results_table / generate_report (one page embedding all)

All take duck-typed ``BenchmarkResult`` rows and return file paths (None
where a chart does not apply or matplotlib is not installed). The
cost environments default to the port's own (a cloud GPU, a shared
cluster, the local CPU), not the JAX report's TPU rows; pass
``cost_models`` for others. matplotlib is imported only when a chart is
drawn (``_mpl``); without it the page holds the tables alone.
"""
from __future__ import annotations

import html
import os
from typing import Optional


def _mpl():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed (the charts are then skipped)."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_bars(results, key_fn, title, ylabel, path):
    plt = _mpl()
    if plt is None:
        return None
    names = [r.workload for r in results]
    vals = [key_fn(r) for r in results]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.bar(names, vals, color="#4878cf")
    ax.set_title(title)
    ax.set_ylabel(ylabel)
    ax.set_yscale("log" if max(vals) / max(min(vals), 1e-12) > 100 else
                  "linear")
    plt.setp(ax.get_xticklabels(), rotation=20, ha="right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# --- per-metric charts ------------------------------------------------------

def plot_execution_time(results, path):
    return _plot_bars(results, lambda r: r.execution_time_s,
                      "Execution time", "seconds", path)


def plot_throughput(results, path):
    return _plot_bars(results, lambda r: r.throughput, "Throughput",
                      "work/s", path)


def plot_memory(results, path):
    return _plot_bars(results, lambda r: max(r.memory_bytes, 1),
                      "State memory", "bytes", path)


def plot_energy(results, path):
    """energy_joules from additional_metrics (host-measured or
    modeled)."""
    rows = [r for r in results
            if r.additional_metrics.get("energy_joules")]
    if not rows:
        return None
    return _plot_bars(rows,
                      lambda r: r.additional_metrics["energy_joules"],
                      "Energy", "joules", path)


def plot_device_utilization(results, path):
    """duty_factor = fraction of wall time the device executes
    (profiler-derived)."""
    rows = [r for r in results
            if r.additional_metrics.get("duty_factor") is not None]
    if not rows:
        return None
    return _plot_bars(rows,
                      lambda r: 100.0 * r.additional_metrics["duty_factor"],
                      "Device utilization", "%", path)


# --- cost charts ------------------------------------------------------------

def _cost_models(models=None):
    from njw_tpu_torch.bench.cost import ComputeEnvironment, CostModelFactory

    return models or {
        e.value: CostModelFactory.create(e) for e in (
            ComputeEnvironment.CLOUD_GPU, ComputeEnvironment.SLURM_CLUSTER,
            ComputeEnvironment.LOCAL_CPU)
    }


def plot_cost_comparison(results, path, models=None):
    """Grouped bars: execution cost of each workload in each
    environment."""
    plt = _mpl()
    if plt is None:
        return None
    models = _cost_models(models)
    names = [r.workload for r in results]
    fig, ax = plt.subplots(figsize=(7.5, 3.8))
    width = 0.8 / max(len(models), 1)
    for k, (env, m) in enumerate(models.items()):
        costs = [m.cost_of(r.execution_time_s)["execution_cost"]
                 for r in results]
        ax.bar([i + k * width for i in range(len(names))], costs,
               width=width, label=str(env))
    ax.set_xticks([i + 0.4 - width / 2 for i in range(len(names))])
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel("execution cost (USD)")
    ax.set_title("Cost comparison")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_cost_per_op(results, path, models=None):
    """Cost per unit of work (throughput-normalized)."""
    plt = _mpl()
    if plt is None:
        return None
    models = _cost_models(models)
    names = [r.workload for r in results]
    fig, ax = plt.subplots(figsize=(7.5, 3.8))
    width = 0.8 / max(len(models), 1)
    for k, (env, m) in enumerate(models.items()):
        cpo = [m.cost_of(r.execution_time_s)["execution_cost"]
               / max(r.throughput * r.execution_time_s, 1e-12)
               for r in results]
        ax.bar([i + k * width for i in range(len(names))], cpo,
               width=width, label=str(env))
    ax.set_xticks([i + 0.4 - width / 2 for i in range(len(names))])
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel("USD per work unit")
    ax.set_yscale("log")
    ax.set_title("Cost per operation")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_break_even(path, models=None, max_hours: float = 24_000.0):
    """Cumulative cost (fixed + variable*t) curves per environment with
    the crossover marked."""
    import numpy as np

    from njw_tpu_torch.bench.cost import break_even_hours

    plt = _mpl()
    if plt is None:
        return None
    models = _cost_models(models)
    t = np.linspace(0.0, max_hours, 200)
    fig, ax = plt.subplots(figsize=(7, 3.8))
    for env, m in models.items():
        ax.plot(t, m.fixed_cost() + m.variable_hourly_rate() * t,
                label=str(env))
    ms = list(models.values())
    be = break_even_hours(ms[0], ms[1]) if len(ms) >= 2 else None
    if be is not None and be <= max_hours:
        ax.axvline(be, color="#999", linestyle="--")
        ax.annotate(f"break-even {be:,.0f} h", (be, ax.get_ylim()[1] * 0.5),
                    fontsize=8, rotation=90, va="center")
    ax.set_xlabel("hours of use")
    ax.set_ylabel("cumulative cost (USD)")
    ax.set_title("Break-even analysis")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# --- scaling charts (rows of bench.scaling) ---------------------------------

def plot_scaling(scaling_rows, path):
    """Throughput vs device count with the ideal-linear reference line."""
    if not scaling_rows:
        return None
    plt = _mpl()
    if plt is None:
        return None
    n = [r["devices"] for r in scaling_rows]
    tp = [r["grid_points_per_second"] for r in scaling_rows]
    fig, ax = plt.subplots(figsize=(6, 3.8))
    ax.plot(n, tp, "o-", color="#4878cf", label="measured")
    ax.plot(n, [tp[0] * k / n[0] for k in n], "--", color="#999",
            label="ideal")
    ax.set_xlabel("devices")
    ax.set_ylabel("grid-points/s")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log", base=2)
    ax.set_title("Scaling")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_scaling_efficiency(scaling_rows, path):
    if not scaling_rows:
        return None
    plt = _mpl()
    if plt is None:
        return None
    n = [str(r["devices"]) for r in scaling_rows]
    eff = [100.0 * r["scaling_efficiency"] for r in scaling_rows]
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar(n, eff, color="#6aa84f")
    ax.axhline(100.0, color="#999", linestyle="--")
    ax.set_xlabel("devices")
    ax.set_ylabel("efficiency (%)")
    ax.set_ylim(0, 115)
    ax.set_title("Scaling efficiency")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# --- tables -----------------------------------------------------------------

def environment_table(results, models=None) -> str:
    """HTML: per-workload cost in each environment + cheapest."""
    models = _cost_models(models)
    head = "".join(f"<th>{html.escape(str(e))}</th>" for e in models)
    rows = []
    for r in results:
        costs = {e: m.cost_of(r.execution_time_s)["execution_cost"]
                 for e, m in models.items()}
        cheapest = min(costs, key=costs.get)
        cells = "".join(
            f"<td{' style=font-weight:bold' if e == cheapest else ''}>"
            f"{c:.6f}</td>" for e, c in costs.items())
        rows.append(f"<tr><td>{html.escape(r.workload)}</td>{cells}"
                    f"<td>{html.escape(str(cheapest))}</td></tr>")
    return (f"<table><tr><th>workload</th>{head}<th>cheapest</th></tr>"
            + "".join(rows) + "</table>")


def results_table(results) -> str:
    rows = "".join(
        "<tr><td>{}</td><td>{}</td><td>{:.4f}</td><td>{:.3e} {}</td>"
        "<td>{}</td><td>{}</td></tr>".format(
            html.escape(r.workload), html.escape(r.device),
            r.execution_time_s, r.throughput,
            html.escape(r.throughput_unit),
            html.escape(f"{r.cost_metrics.get('execution_cost', 0):.6f} "
                        f"{r.cost_metrics.get('currency', '')}")
            if r.cost_metrics else "-",
            html.escape(r.timestamp))
        for r in results)
    return ("<table><tr><th>workload</th><th>device</th><th>time (s)</th>"
            "<th>throughput</th><th>cost</th><th>timestamp</th></tr>"
            + rows + "</table>")


def generate_report(results, output_dir: str,
                    title: str = "njw_tpu_torch benchmark report",
                    scaling_rows: Optional[list] = None,
                    cost_models=None) -> str:
    """Run every applicable generator; write index.html embedding all.
    Returns the html path."""
    os.makedirs(output_dir, exist_ok=True)
    plots = []

    def add(p):
        if p:
            plots.append(p)

    j = os.path.join
    if results:
        add(plot_execution_time(results, j(output_dir, "execution_time.png")))
        add(plot_throughput(results, j(output_dir, "throughput.png")))
        if any(r.memory_bytes for r in results):
            add(plot_memory(results, j(output_dir, "memory.png")))
        add(plot_energy(results, j(output_dir, "energy.png")))
        add(plot_device_utilization(results, j(output_dir, "util.png")))
        add(plot_cost_comparison(results, j(output_dir, "cost.png"),
                                 cost_models))
        add(plot_cost_per_op(results, j(output_dir, "cost_per_op.png"),
                             cost_models))
    add(plot_break_even(j(output_dir, "break_even.png"), cost_models))
    if scaling_rows:
        add(plot_scaling(scaling_rows, j(output_dir, "scaling.png")))
        add(plot_scaling_efficiency(
            scaling_rows, j(output_dir, "scaling_efficiency.png")))

    imgs = "".join(f'<img src="{os.path.basename(p)}" '
                   'style="max-width:100%">' for p in plots)
    env_tbl = environment_table(results, cost_models) if results else ""
    page = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse;margin-bottom:1.5em}}td,th{{border:1px solid #999;
padding:4px 10px}}</style></head>
<body><h1>{html.escape(title)}</h1>
{results_table(results)}
<h2>environment cost comparison</h2>
{env_tbl}
{imgs}</body></html>"""
    path = os.path.join(output_dir, "index.html")
    with open(path, "w") as fh:
        fh.write(page)
    return path
