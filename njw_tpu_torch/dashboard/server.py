"""stdlib HTTP dashboard server: counterpart of
``njw_tpu/dashboard/server.py``.

REST endpoints, a live channel as Server-Sent Events, and the
geo-financial views as JSON endpoints rendered by the static canvas
client. The server describes the device it was given (``device``, CUDA
unless given, which must exist): /api/cluster reports the card, or the
CPU when asked.

Endpoints:
  /api/results            benchmark results (typed BenchmarkResultRow —
                          schema shared with proto/dashboard.proto via
                          njw_tpu_torch.dashboard.schema)
  /api/workloads          distinct workload names
  /api/cluster            device/cluster overview + per-workload summary
                          (ref: ClusterOverview.tsx:1-175)
  /api/history            throughput-over-run-history series per workload
                          (ref: PerformanceChart.tsx:1-164)
  /api/schema             the parsed proto schema (for typed consumers)
  /api/stream             SSE live events (benchmark + geo-financial)
  /api/geofin/portfolio   asset table + per-asset risk + totals
  /api/geofin/riskmap     rasterized risk surface + asset overlay
  /api/geofin/scenarios   scenario losses / VaR / worst case
  /, /cluster, /perf, /geofin   static UI pages
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from njw_tpu_torch.platform.device import require_device

_STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


class DashboardServer:
    """Serves /api/results, /api/workloads, /api/stream (SSE), optional
    geo-financial views, and the static UI."""

    def __init__(self, results_path: str, host: str = "127.0.0.1",
                 port: int = 5000, geofin=None, device="cuda"):
        self.results_path = results_path
        self.host = host
        self.port = port
        self.geofin = geofin          # GeoFinDashboard or None
        self.device = require_device(device)
        from njw_tpu_torch.dashboard.geofin import EventBroker

        self.broker = geofin.broker if geofin is not None else EventBroker()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def publish(self, event: dict) -> int:
        """Push a live event to all SSE subscribers."""
        return self.broker.publish(event)

    def _load(self) -> list:
        if not os.path.exists(self.results_path):
            return []
        from njw_tpu_torch.dashboard.schema import normalize_row

        with open(self.results_path) as fh:
            return [normalize_row(r) for r in json.load(fh)]

    def _cluster_view(self) -> dict:
        """The server's device + per-workload summary from the results
        history."""
        from njw_tpu_torch.platform.device import get_device_info

        rows = self._load()
        by_wl: dict[str, list] = {}
        for r in rows:
            by_wl.setdefault(r["workload"], []).append(r)
        summaries = []
        for wl in sorted(by_wl):
            rs = sorted(by_wl[wl], key=lambda r: r["timestamp"])
            best = max(rs, key=lambda r: r["throughput"])
            summaries.append({
                "workload": wl,
                "runs": len(rs),
                "best_throughput": best["throughput"],
                "throughput_unit": best["throughput_unit"],
                "last_timestamp": rs[-1]["timestamp"],
            })
        info = get_device_info(self.device)
        return {
            "platform": info["platform"],
            "generation": info["generation"],
            "num_devices": info["num_devices"],
            "hbm_gb": info["hbm_gb"],
            "hbm_bandwidth_gbps": info["hbm_bandwidth_gbps"],
            "peak_bf16_tflops": info["peak_bf16_tflops"],
            "total_runs": len(rows),
            "workloads": summaries,
        }

    def _history_view(self) -> list:
        """Throughput over run history, one series per workload
        (ref: PerformanceChart.tsx:1-164)."""
        rows = self._load()
        by_wl: dict[str, list] = {}
        for r in rows:
            by_wl.setdefault(r["workload"], []).append(r)
        series = []
        for wl in sorted(by_wl):
            rs = sorted(by_wl[wl], key=lambda r: r["timestamp"])
            series.append({
                "workload": wl,
                "throughput_unit": rs[0]["throughput_unit"],
                "points": [{"timestamp": r["timestamp"],
                            "throughput": r["throughput"],
                            "device": r["device"]} for r in rs],
            })
        return series

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, payload, code=200):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _static(self, name, ctype="text/html"):
                path = os.path.join(_STATIC_DIR, name)
                if not os.path.exists(path):
                    return self._json({"error": "not found"}, 404)
                with open(path, "rb") as fh:
                    body = fh.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse(self):
                """Server-sent events: blocks, streaming broker events
                (the reference's socket.io live channel role)."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                last = -1
                try:
                    while True:
                        fresh = server.broker.wait_since(last, timeout=5.0)
                        if not fresh:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        for eid, event in fresh:
                            data = json.dumps(event)
                            self.wfile.write(
                                f"id: {eid}\ndata: {data}\n\n".encode())
                            last = eid
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return

            def do_GET(self):
                parsed = urlparse(self.path)
                route = parsed.path
                if route == "/api/results":
                    self._json(server._load())
                elif route == "/api/workloads":
                    rows = server._load()
                    self._json(sorted({r["workload"] for r in rows}))
                elif route == "/api/cluster":
                    self._json(server._cluster_view())
                elif route == "/api/history":
                    self._json(server._history_view())
                elif route == "/api/schema":
                    from njw_tpu_torch.dashboard.schema import (
                        parse_proto_messages,
                    )

                    self._json({
                        m: {f: {"type": t, "repeated": rep}
                            for f, (t, rep) in fields.items()}
                        for m, fields in parse_proto_messages().items()
                    })
                elif route == "/api/stream":
                    self._sse()
                elif route.startswith("/api/geofin/"):
                    if server.geofin is None:
                        return self._json(
                            {"error": "no geo-financial context"}, 404)
                    if route == "/api/geofin/portfolio":
                        self._json(server.geofin.portfolio_view())
                    elif route == "/api/geofin/riskmap":
                        q = parse_qs(parsed.query)
                        w = int(q.get("w", ["128"])[0])
                        h = int(q.get("h", ["128"])[0])
                        self._json(server.geofin.risk_map(w, h))
                    elif route == "/api/geofin/scenarios":
                        self._json(server.geofin.scenario_view())
                    else:
                        self._json({"error": "not found"}, 404)
                elif route in ("/", "/index.html"):
                    self._static("index.html")
                elif route in ("/cluster", "/cluster.html"):
                    self._static("cluster.html")
                elif route in ("/perf", "/perf.html"):
                    self._static("perf.html")
                elif route in ("/geofin", "/geofin.html"):
                    self._static("geofin.html")
                else:
                    self._json({"error": "not found"}, 404)

        return Handler

    def start(self) -> "DashboardServer":
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def demo_geofin(device="cuda"):
    """The synthetic geo-financial context of ``--demo-geofin``: a 256^2
    DEM on ``device`` with its flood and elevation factors, 60 assets
    tagged with three symbols, the climate scenarios, and a market stream
    (not started) attached to the views. Returns (views, stream)."""
    import torch

    from njw_tpu_torch.dashboard.geofin import GeoFinDashboard
    from njw_tpu_torch.geofinancial.geo_risk import (
        GeospatialRiskModel, create_elevation_risk_factor,
        create_flood_risk_factor,
    )
    from njw_tpu_torch.geofinancial.realtime import MarketDataStream
    from njw_tpu_torch.geofinancial.scenarios import create_climate_scenarios
    from njw_tpu_torch.geofinancial.testdata import (
        generate_assets, generate_dem,
    )

    dev = require_device(device)
    dem = torch.from_numpy(generate_dem(256, seed=1)).to(dev)
    model = GeospatialRiskModel([
        create_flood_risk_factor(dem, weight=1.0),
        create_elevation_risk_factor(dem, weight=0.5),
    ])
    port = generate_assets(60, extent=256.0, seed=1)
    syms = ["NJW", "TPU", "XLA"]
    for i, a in enumerate(port.assets):
        a.metadata["symbol"] = syms[i % len(syms)]
    geofin = GeoFinDashboard(port, model,
                             scenarios=create_climate_scenarios())
    stream = MarketDataStream(syms, interval_s=2.0)
    geofin.attach_stream(stream)
    return geofin, stream


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="njw_tpu_torch.dashboard")
    p.add_argument("--results", default="benchmark_results/results.json")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", default="cuda",
                   help="the device the server describes and the demo's "
                        "risk factors are built on (cuda or cpu)")
    p.add_argument("--demo-geofin", action="store_true",
                   help="serve a synthetic geo-financial dashboard with a "
                        "live market stream")
    args = p.parse_args(argv)

    geofin = None
    stream = None
    if args.demo_geofin:
        geofin, stream = demo_geofin(args.device)
        stream.start()

    server = DashboardServer(args.results, args.host, args.port,
                             geofin=geofin, device=args.device).start()
    print(f"dashboard at {server.url} (ctrl-c to stop)")
    if geofin is not None:
        print(f"geo-financial views at {server.url}/geofin")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        if stream is not None:
            stream.stop()
        server.stop()
    return 0
