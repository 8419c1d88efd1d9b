"""Stage timing and profiler traces (port of zkfhe_tpu/utils/profiling.py).

On a CUDA device a mark records an event on the current stream and
nothing waits for the device: a stage's time is the device's time between
two marks, read only by ``summary()``. A prover that interleaves other
work on the stream (``parallel/pipeline.py``) never blocks on a mark.
Elsewhere a stage's time is the host clock between two marks.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class StageTimer:
    """Collects named stage durations, in the order they end."""

    def __init__(self, device=None):
        dev = None if device is None else torch.device(device)
        self._stream = (torch.cuda.current_stream(dev)
                        if dev is not None and dev.type == "cuda" else None)
        self.marks = []  # (name, start, end): events or host times
        self._last = self._now()

    def _now(self):
        if self._stream is None:
            return time.time()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def mark(self, name: str):
        """End the stage that began at construction or at the end of the
        previous mark or stage."""
        now = self._now()
        self.marks.append((name, self._last, now))
        self._last = now

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        """Time the body of a ``with`` block as one stage. ``sync=True``:
        the host also waits, before the block ends, for the device work
        the body queued, so a host clock read after the block includes it
        (the stage's own time is the same either way). The next mark's
        stage begins where this one ends, so no time is counted twice."""
        start = self._now()
        yield
        if sync and self._stream is not None:
            self._stream.synchronize()
        end = self._now()
        self.marks.append((name, start, end))
        self._last = end

    def summary(self) -> dict:
        """name -> seconds; on a CUDA device, waits for the last mark."""
        if self._stream is not None and self.marks:
            self.marks[-1][2].synchronize()
        out = {}
        for name, start, end in self.marks:
            dt = (end - start if self._stream is None
                  else start.elapsed_time(end) / 1e3)
            out[name] = round(dt, 4)
        return out

    def dump(self, path: str):
        """Write summary() to `path` as JSON."""
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


@contextlib.contextmanager
def maybe_trace(out_dir: str | None = None, enabled: bool | None = None):
    """A torch.profiler run of the body (host and, where there is one,
    CUDA activity) when `enabled`, by default when `out_dir` is given; the
    trace is exported as ``out_dir/trace.json`` when `out_dir` is given.
    Yields the profiler, or None when nothing is profiled."""
    if not (bool(out_dir) if enabled is None else enabled):
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def device_busy_s(prof) -> float:
    """Seconds of device activity (kernels, copies) a finished
    torch.profiler run recorded; 0.0 when it traced no device."""
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e6
