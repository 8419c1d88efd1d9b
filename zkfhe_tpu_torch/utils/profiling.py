"""Stage timing (port of zkfhe_tpu/utils/profiling.py).

A stage's time is the host clock between two marks, each taken after
``torch.cuda.synchronize()`` when the timer watches a CUDA device, so a
stage holds the device work it enqueued.
"""
from __future__ import annotations

import sys
import time

import torch


class StageTimer:
    """Collects named stage durations; prints each one unless stream is
    None."""

    def __init__(self, label: str = "zkfhe", stream=sys.stderr,
                 device=None):
        self.label = label
        self.stream = stream
        self.device = None if device is None else torch.device(device)
        self.stages = []
        self._last = self._now()

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def mark(self, name: str):
        """Record the time since construction or the previous mark."""
        now = self._now()
        self._record(name, now - self._last)

    def _record(self, name, dt):
        self.stages.append((name, dt))
        self._last = time.time()
        if self.stream is not None:
            print(f"[{self.label}] {name}: {dt:.3f}s", file=self.stream,
                  flush=True)

    def summary(self) -> dict:
        return {name: round(dt, 4) for name, dt in self.stages}
