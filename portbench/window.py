"""The measured window and the end-to-end arithmetic over it.

A window is a closed loop: one client makes a call, waits for its proofs,
and makes the next. It opens when the first call starts and closes when
the first call that ends ``seconds`` or more after the opening ends, so
every proof counted was made inside the window and every second of the
window is counted.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class Window:
    t_open: float
    t_close: float
    proofs: int
    calls: int

    @property
    def wall_s(self) -> float:
        return self.t_close - self.t_open


def run_window(call, seconds: float, clock=time.perf_counter) -> Window:
    """Drive ``call(i)`` for i = 0, 1, ... until one ends at or after
    ``seconds``; each call returns the number of proofs it completed."""
    t_open = clock()
    proofs = calls = 0
    while True:
        proofs += call(calls)
        calls += 1
        t = clock()
        if t - t_open >= seconds:
            return Window(t_open, t, proofs, calls)


# end-to-end metrics over a window, by the name BENCHMARK.json gives them
END_TO_END = {
    # one client's latency: the window's wall time over the proofs in it
    "prove_s": lambda w: w.wall_s / w.proofs,
    # a queue's throughput: the proofs over the window's wall time
    "proofs_per_s": lambda w: w.proofs / w.wall_s,
}
