"""Table-MSM calls a proof makes (ops/msm.CALLS["msm_tab"] over the
window, divided by the proofs)."""
from portbench.readers import per_proof


def read(ctx):
    return per_proof(ctx, ctx.msm_calls.get("msm_tab", 0))
