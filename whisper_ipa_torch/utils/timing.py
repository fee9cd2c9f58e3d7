"""Timing helpers: step timers and throughput meters.

The PyTorch package's copy of ``whisper_ipa_tpu/utils/timing.py``. Device
work is waited for before a timer stops (``stop(sync=...)`` synchronizes
the CUDA devices that hold the given tensors), so timings reflect real
completion, not asynchronous launches.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from .trees import tree_leaves


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates wall-clock samples with mean/percentile summaries."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync=None) -> float:
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def mean(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(int(q / 100.0 * len(s)), len(s) - 1)
        return s[idx]


class Throughput:
    """items/sec over a rolling window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: List[tuple] = []

    def update(self, n_items: int):
        self._events.append((time.perf_counter(), n_items))
        self._events = self._events[-self.window :]

    @property
    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        items = sum(n for _, n in self._events[1:])
        return items / dt if dt > 0 else 0.0
