"""Stage timing (port of zkfhe_tpu/utils/profiling.py).

On a CUDA device a mark records an event on the current stream and
nothing waits for the device: a stage's time is the device's time between
two marks, read only by ``summary()``. A prover that interleaves other
work on the stream (``parallel/pipeline.py``) never blocks on a mark.
Elsewhere a stage's time is the host clock between two marks.
"""
from __future__ import annotations

import time

import torch


class StageTimer:
    """Collects named stage durations, in mark order."""

    def __init__(self, device=None):
        dev = None if device is None else torch.device(device)
        self._stream = (torch.cuda.current_stream(dev)
                        if dev is not None and dev.type == "cuda" else None)
        self.marks = []  # (name, event or host time)
        self._start = self._now()

    def _now(self):
        if self._stream is None:
            return time.time()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def mark(self, name: str):
        """End the stage that began at construction or the previous
        mark."""
        self.marks.append((name, self._now()))

    def summary(self) -> dict:
        """name -> seconds; on a CUDA device, waits for the last mark."""
        if self._stream is not None and self.marks:
            self.marks[-1][1].synchronize()
        out, last = {}, self._start
        for name, t in self.marks:
            dt = (t - last if self._stream is None
                  else last.elapsed_time(t) / 1e3)
            out[name] = round(dt, 4)
            last = t
        return out
