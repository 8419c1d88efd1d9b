"""Seconds a proof spends in the commitment phase: the prover's stages
witgen0 through perm_commit (prover.LAST_STAGES, device time between the
stage marks, which sit where each stage's work was enqueued)."""
from portbench.readers import stage_span_per_proof


def read(ctx):
    return stage_span_per_proof(ctx, "witgen0", "perm_commit")
