"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the run's ``Context`` and returns a number, or None when
the run holds nothing for it to read, or raises ValueError when what it
reads disagrees with itself; the harness then leaves the metric out of
the result line and names it, with the reason, under the line's
``unread`` key. One reader serves every traffic suffix of its metric:
``metrics/commit_phase_s.py`` reads ``commit_phase_s.serial`` and
``commit_phase_s.batch``.
"""
from __future__ import annotations

import dataclasses

from . import kernels

# the port's prover stages (backend/prover.py, backend/batch.py), in order
STAGES = ("witgen0", "phase0_commit", "witgen1", "phase1_commit",
          "lookup_commit", "perm_z", "perm_commit", "quot_terms",
          "quotient", "evals", "multiopen")


@dataclasses.dataclass
class Context:
    proofs: int  # proofs completed in the window
    stages: list  # prover.LAST_STAGES after each call: {stage: seconds}
    msm_calls: dict  # ops/msm.CALLS over the window
    launches: dict  # field_kernels.LAUNCHES and mxu_field.LAUNCHES
    peak_bytes: int | None  # torch.cuda.max_memory_allocated, the window
    trace: object | None = None  # trace.Summary of the traced window
    lanes: dict | None = None  # field kernel -> lanes of each launch
    peak: dict = dataclasses.field(default_factory=lambda: kernels.DEFAULT_PEAK)


def stage_span_per_proof(ctx: Context, first: str, last: str):
    """Seconds a proof spent in the stages ``first`` through ``last``."""
    names = STAGES[STAGES.index(first):STAGES.index(last) + 1]
    if not ctx.proofs or not any(n in st for st in ctx.stages for n in names):
        return None  # an entry point that times no stages
    total = sum(st.get(n, 0.0) for st in ctx.stages for n in names)
    return total / ctx.proofs


def per_proof(ctx: Context, count):
    return None if not ctx.proofs else count / ctx.proofs
