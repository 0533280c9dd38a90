"""Realtime data streams.

Counterpart of ``njw_tpu/geofinancial/realtime.py``, copied: a background
thread calls its subscribers at an interval (simulated market prices by
geometric Brownian motion, simulated geospatial hazard events).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np


class DataStreamSource:
    """Background thread invoking subscriber callbacks at an interval
    (ref: realtime_data.py:49-104)."""

    def __init__(self, interval_s: float = 1.0, name: str = "stream"):
        self.interval_s = interval_s
        self.name = name
        self._subscribers: list[Callable] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def subscribe(self, callback: Callable):
        self._subscribers.append(callback)
        return self

    def fetch(self) -> dict:  # override in subclasses
        return {"ts": time.time()}

    def _loop(self):
        while not self._stop.is_set():
            payload = self.fetch()
            for cb in list(self._subscribers):
                try:
                    cb(payload)
                except Exception:  # noqa: BLE001 — one bad subscriber
                    pass           # must not kill the stream
            self._stop.wait(self.interval_s)

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class MarketDataStream(DataStreamSource):
    """Simulated market prices via geometric Brownian motion
    (ref: realtime_data.py:109 simulated mode)."""

    def __init__(self, symbols: list[str], interval_s: float = 1.0,
                 volatility: float = 0.02, seed: int = 0):
        super().__init__(interval_s, "market")
        self.symbols = list(symbols)
        self.volatility = volatility
        self._rng = np.random.default_rng(seed)
        self.prices = {s: 100.0 for s in self.symbols}

    def fetch(self) -> dict:
        for s in self.symbols:
            shock = self._rng.normal(0.0, self.volatility)
            self.prices[s] = max(self.prices[s] * (1.0 + shock), 0.01)
        return {"ts": time.time(), "prices": dict(self.prices)}


class GeospatialEventStream(DataStreamSource):
    """Simulated geospatial hazard events (ref: realtime_data.py:243)."""

    def __init__(self, extent=(0.0, 100.0, 0.0, 100.0),
                 interval_s: float = 1.0, event_rate: float = 0.5,
                 seed: int = 0):
        super().__init__(interval_s, "geo_events")
        self.extent = extent
        self.event_rate = event_rate
        self._rng = np.random.default_rng(seed)

    def fetch(self) -> dict:
        events = []
        n = self._rng.poisson(self.event_rate)
        for _ in range(n):
            events.append({
                "x": float(self._rng.uniform(self.extent[0], self.extent[1])),
                "y": float(self._rng.uniform(self.extent[2], self.extent[3])),
                "severity": float(self._rng.uniform(0.1, 1.0)),
                "kind": str(self._rng.choice(
                    ["flood", "storm", "wildfire"])),
            })
        return {"ts": time.time(), "events": events}
