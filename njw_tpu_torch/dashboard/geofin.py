"""Geo-financial dashboard views: counterpart of
``njw_tpu/dashboard/geofin.py``.

A data provider renders the risk map, portfolio and scenario views as
JSON for the stdlib ``DashboardServer`` (canvas/SVG client) and pushes
live updates over Server-Sent Events (``EventBroker``).

The models are the port's (``njw_tpu_torch.geofinancial``): their risk
factors were built on the model's device (the DEM sweeps of
``create_flood_risk_factor`` and ``create_slope_risk_factor``) and hold
host surfaces, so a view samples them on the host and converts to plain
Python at the JSON boundary. HTTP handler threads and a market stream's
callback thread share one provider: every view holds its lock.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from njw_tpu_torch.geofinancial.aggregation import RiskSurfaceGenerator
from njw_tpu_torch.geofinancial.geo_risk import (
    GeospatialPortfolio, GeospatialRiskModel,
)
from njw_tpu_torch.viz._common import to_numpy


class EventBroker:
    """Thread-safe fan-out of JSON events to SSE subscribers."""

    def __init__(self, history: int = 64):
        self._lock = threading.Condition()
        self._events: list[tuple[int, dict]] = []
        self._next_id = 0
        self._history = history

    def publish(self, event: dict) -> int:
        with self._lock:
            eid = self._next_id
            self._next_id += 1
            self._events.append((eid, event))
            if len(self._events) > self._history:
                self._events = self._events[-self._history:]
            self._lock.notify_all()
            return eid

    def wait_since(self, last_id: int, timeout: float = 10.0):
        """Events with id > last_id, blocking up to timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                fresh = [(i, e) for i, e in self._events if i > last_id]
                if fresh:
                    return fresh
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(remaining)


class GeoFinDashboard:
    """Data provider for the geo-financial dashboard views.

    Views (all plain-JSON):
      portfolio_view()  asset table + per-asset risk (ref
                        dashboard_app.py portfolio panel)
      risk_map(w, h)    rasterized combined risk surface + asset overlay
                        (ref dashboard_app.py risk map)
      scenario_view()   per-scenario expected losses (ref
                        dashboard_app.py scenario comparison)
      on_stream_event() wire to realtime.DataStreamSource; re-assesses
                        and publishes over the broker (ref
                        realtime_dashboard.py live loop)
      risk_grid(w, h)   the risk map's raster before rounding
    """

    def __init__(self, portfolio: GeospatialPortfolio,
                 model: GeospatialRiskModel,
                 scenarios=None, broker: Optional[EventBroker] = None):
        self.portfolio = portfolio
        self.model = model
        self.scenarios = scenarios
        self.broker = broker or EventBroker()
        self._lock = threading.Lock()

    # --- views ----------------------------------------------------------
    def portfolio_view(self) -> dict:
        with self._lock:
            risks = self.portfolio.assess_risk(self.model)
            assets = [{
                "id": a.id, "name": a.name, "value": a.value,
                "x": a.x, "y": a.y,
                "sector": a.metadata.get("sector", ""),
                "risk": float(risks.get(a.id, 0.0)),
            } for a in self.portfolio.assets]
        total = sum(a["value"] for a in assets) or 1.0
        weighted = sum(a["value"] * a["risk"] for a in assets) / total
        return {
            "assets": assets,
            "total_value": total,
            "value_weighted_risk": weighted,
            "expected_loss": weighted * total,
        }

    def risk_grid(self, width: int = 128, height: int = 128):
        """The combined risk surface on a (height, width) raster, float64
        before any rounding, and its extent [x0, x1, y0, y1]."""
        with self._lock:
            if self.model.risk_factors:
                h0, w0 = self.model.risk_factors[0].risk_data.shape
                ys = np.linspace(0, h0 - 1, height)
                xs = np.linspace(0, w0 - 1, width)
                gx, gy = np.meshgrid(xs, ys)
                grid = self.model.assess_risk(gx.ravel(), gy.ravel()) \
                    .reshape(height, width)
                extent = [0.0, float(w0 - 1), 0.0, float(h0 - 1)]
            else:
                xs_a = [a.x for a in self.portfolio.assets]
                ys_a = [a.y for a in self.portfolio.assets]
                risks = self.portfolio.assess_risk(self.model)
                extent = [min(xs_a), max(xs_a), min(ys_a), max(ys_a)]
                grid = RiskSurfaceGenerator().generate(
                    xs_a, ys_a, list(risks.values()),
                    (height, width), extent)
        return to_numpy(grid, np.float64), extent

    def risk_map(self, width: int = 128, height: int = 128) -> dict:
        """Combined model risk surface on a raster (4 decimals) + asset
        points; the canvas client colormaps `grid` directly."""
        grid, extent = self.risk_grid(width, height)
        with self._lock:
            assets = [{"x": a.x, "y": a.y, "value": a.value,
                       "id": a.id} for a in self.portfolio.assets]
        return {
            "grid": np.round(grid, 4).tolist(),
            "extent": extent, "width": width, "height": height,
            "assets": assets,
        }

    def scenario_view(self) -> dict:
        if self.scenarios is None:
            return {"scenarios": [], "expected_loss": 0.0}
        from njw_tpu_torch.geofinancial.scenarios import ScenarioAnalyzer

        with self._lock:
            analyzer = ScenarioAnalyzer(self.portfolio, self.model)
            agg = analyzer.evaluate_set(self.scenarios)
            var95 = analyzer.var(self.scenarios, 0.95)
        return {
            "set": agg["set"],
            "scenarios": agg["results"],
            "expected_loss": agg["expected_loss"],
            "worst_case": agg["worst_case"],
            "worst_loss": agg["worst_loss"],
            "value_at_risk_95": var95,
        }

    # --- live updates -----------------------------------------------------
    def on_stream_event(self, payload: dict):
        """Callback for realtime.DataStreamSource.subscribe: market price
        moves reprice symbol-tagged assets; geospatial hazard events are
        forwarded; then re-assess and publish over SSE."""
        with self._lock:
            prices = payload.get("prices", {})
            if prices:
                prev = getattr(self, "_prev_prices", {})
                for a in self.portfolio.assets:
                    sym = a.metadata.get("symbol")
                    if sym in prices and sym in prev and prev[sym] > 0:
                        a.value *= float(prices[sym]) / prev[sym]
                self._prev_prices = dict(prices)
            if payload.get("events"):
                self.broker.publish({"type": "geo_events",
                                     "events": payload["events"]})
        view = self.portfolio_view()
        self.broker.publish({
            "type": "portfolio_update",
            "time": payload.get("ts", time.time()),
            "total_value": view["total_value"],
            "expected_loss": view["expected_loss"],
            "value_weighted_risk": view["value_weighted_risk"],
        })

    def attach_stream(self, stream) -> None:
        """Subscribe a realtime DataStreamSource (started by caller)."""
        stream.subscribe(self.on_stream_event)
