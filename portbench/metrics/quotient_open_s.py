"""Seconds a proof spends in the quotient and opening phase: the
prover's stages quot_terms through multiopen (prover.LAST_STAGES)."""
from portbench.readers import stage_span_per_proof


def read(ctx):
    return stage_span_per_proof(ctx, "quot_terms", "multiopen")
