"""Benchmark dashboard: counterpart of ``njw_tpu.dashboard``.

A stdlib HTTP server that serves the typed JSON result rows at
/api/results (schema shared with ``proto/dashboard.proto``), the device
overview of the card it runs on, run history, the geo-financial views
and live Server-Sent Events, with a static single-page UI (vanilla JS,
no CDN: works offline). Start with:

    python -m njw_tpu_torch.dashboard --results benchmark_results/results.json
    python -m njw_tpu_torch.dashboard --demo-geofin          # on the card
    python -m njw_tpu_torch.dashboard --demo-geofin --device cpu
"""
from njw_tpu_torch.dashboard.server import DashboardServer
