"""Device-aware batch planning for risk workloads.

Counterpart of ``njw_tpu/geofinancial/optimizer.py`` (the name
``TPUOptimizer`` is kept, as every name of that package is): the batch
size follows the device's memory from ``njw_tpu_torch.platform.detect``
(``total_memory_bytes``; 4 GB on the CPU, as in the JAX package) and is
a multiple of 128.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from njw_tpu_torch.platform.device import DeviceCaps, detect


class TPUOptimizer:
    """Batch and tile sizes from the device's memory; batched risk
    assessment. ``caps`` describes the device, else ``detect(device)``
    (CUDA unless given)."""

    def __init__(self, caps: Optional[DeviceCaps] = None,
                 memory_fraction: float = 0.5, *, device=None):
        self.caps = caps or detect("cuda" if device is None else device)
        self.memory_fraction = memory_fraction

    def optimal_batch_size(self, bytes_per_item: int,
                           max_batch: int = 1 << 22) -> int:
        """Largest 128-aligned batch that fits the memory budget."""
        budget = self.caps.total_memory_bytes * self.memory_fraction
        if self.caps.total_memory_bytes == 0:  # the CPU reports none
            budget = 4e9 * self.memory_fraction
        n = int(budget // max(bytes_per_item, 1))
        n = min(n, max_batch)
        return max((n // 128) * 128, 128)

    def optimal_tile_size(self, n_points: int) -> int:
        """Grid tile edge, a multiple of 128 up to 1024."""
        side = int(np.sqrt(max(n_points, 1)))
        return max(min((side // 128) * 128, 1024), 128)

    def batched_risk_assessment(self, portfolio, model, batch_size:
                                Optional[int] = None) -> dict:
        """Assess a large portfolio in device-sized batches."""
        assets = portfolio.assets
        if not assets:
            return {}
        bs = batch_size or self.optimal_batch_size(8 * 4)
        out = {}
        for i in range(0, len(assets), bs):
            chunk = assets[i:i + bs]
            x = np.asarray([a.x for a in chunk], np.float32)
            y = np.asarray([a.y for a in chunk], np.float32)
            scores = model.assess_risk(x, y)
            out.update({a.id: float(s) for a, s in zip(chunk, scores)})
        return out

    def benchmark(self, portfolio, model, n_repeats: int = 3) -> dict:
        """Seconds per pass and assets per second of the batched
        assessment (host wall clock)."""
        t0 = time.perf_counter()
        for _ in range(n_repeats):
            self.batched_risk_assessment(portfolio, model)
        elapsed = (time.perf_counter() - t0) / n_repeats
        n = len(portfolio.assets)
        return {
            "assets": n,
            "seconds_per_pass": elapsed,
            "assets_per_second": n / max(elapsed, 1e-12),
            "device": self.caps.name,
        }
