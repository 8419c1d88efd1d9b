"""Reduction of a profiler trace of the window to the device's busy time,
its idle gaps and the field kernels' device time.

The traced window is a ``record_function`` span named ``WINDOW``; each
call of the prover is a ``CALL`` span, and the end of each prover stage
(the port's ``StageTimer`` marks, on the host, where the stage's work has
been enqueued) a ``STAGE_END + <stage>`` span. Events are kept in memory
and reduced here; no trace file is written.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import typing

PREFIX = "portbench."
WINDOW = PREFIX + "window"
CALL = PREFIX + "call"
STAGE_END = PREFIX + "stage_end:"

# the port's field kernels (csrc/field_kernels.cu) by their device names
FIELD_KERNEL = re.compile(r"(?:^|\W)k_(mont_mul|add|sub|bfly_dif|bfly)<")

TOP = 10


class Event(typing.NamedTuple):
    name: str
    device: bool  # ran on the card (kernel, copy, memset)
    start: int  # ns
    dur: int  # ns
    annotation: bool = False  # a record_function span of the harness

    @property
    def end(self) -> int:
        return self.start + self.dur


def from_profiler(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``, read from its
    Kineto results without building the profiler's own event tree."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        # a harness span shows twice: on the host, and on the card as the
        # range of the kernels inside it, which is no device work
        out.append(Event(name, e.device_type() == cuda, e.start_ns(),
                         e.duration_ns(), name.startswith(PREFIX)))
    return out


def merge(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(merged, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi] that ``merged`` (from ``merge``) leaves."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class _HostIndex:
    """What the host was doing at a time: the prover stage (by the stage
    marks of the call around it) and the innermost host op."""

    def __init__(self, events):
        ops = sorted((e for e in events if not e.device and not e.annotation),
                     key=lambda e: e.start)
        self.op_start = [e.start for e in ops]
        self.ops = ops
        calls = sorted((e for e in events if e.annotation and not e.device
                        and e.name == CALL), key=lambda e: e.start)
        self.call_start = [e.start for e in calls]
        self.calls = calls
        marks = sorted(((e.start, e.name[len(STAGE_END):]) for e in events
                        if e.annotation and not e.device
                        and e.name.startswith(STAGE_END)))
        self.mark_t = [t for t, _ in marks]
        self.mark_name = [n for _, n in marks]

    def stage(self, t: int) -> str:
        i = bisect.bisect_right(self.call_start, t) - 1
        if i < 0 or t >= self.calls[i].end:
            return "harness"
        j = bisect.bisect_left(self.mark_t, t)
        if j < len(self.mark_t) and self.mark_t[j] < self.calls[i].end:
            return self.mark_name[j]
        return "proof_tail"

    def op(self, t: int, depth: int = 64) -> str:
        i = bisect.bisect_right(self.op_start, t) - 1
        for j in range(i, max(i - depth, -1), -1):
            if self.ops[j].end >= t:
                return self.ops[j].name
        return "python"


@dataclasses.dataclass
class Summary:
    window_ns: int
    busy_ns: int
    device_ops: list  # [[name, seconds]] most device time first
    idle_gaps: list  # [[stage/host op, seconds]] most idle time first
    field_kernel_ns: dict  # kernel -> [device ns of each launch, in order]


def summarize(events: list[Event]) -> Summary | None:
    """Busy time (the union of device intervals), idle gaps by what the
    host was doing, device time by op name, and each field-kernel launch's
    device time, all inside the WINDOW span; None without that span."""
    win = [e for e in events
           if e.annotation and not e.device and e.name == WINDOW]
    if not win:
        return None
    lo, hi = win[0].start, win[0].end
    dev = [e for e in events if e.device and not e.annotation
           and e.end > lo and e.start < hi]
    dev.sort(key=lambda e: e.start)
    merged = merge(((e.start, e.end) for e in dev), lo, hi)
    busy = sum(e - s for s, e in merged)
    by_op = collections.Counter()
    field = collections.defaultdict(list)
    kind = {}  # device name -> field kernel or None
    for e in dev:
        by_op[e.name] += e.dur
        if e.name not in kind:
            m = FIELD_KERNEL.search(e.name)
            kind[e.name] = m and m.group(1)
        if kind[e.name]:
            field[kind[e.name]].append(e.dur)
    host = _HostIndex(events)
    idle = collections.Counter()
    for s, e in gaps(merged, lo, hi):
        idle[f"{host.stage(s)}/{host.op(s)}"] += e - s
    return Summary(
        window_ns=hi - lo, busy_ns=busy,
        device_ops=[[n, ns / 1e9] for n, ns in by_op.most_common(TOP)],
        idle_gaps=[[n, ns / 1e9] for n, ns in idle.most_common(TOP)],
        field_kernel_ns=dict(field))
