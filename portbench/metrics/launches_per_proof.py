"""Hand-written kernel launches a proof makes: the five field kernels
(ops/field_kernels.LAUNCHES) and the matmul's two (ops/mxu_field.LAUNCHES
without its "mat_mul_mont" call count), over the window, per proof."""
from portbench.readers import per_proof


def read(ctx):
    n = sum(v for k, v in ctx.launches.items() if k != "mat_mul_mont")
    return per_proof(ctx, n) if n else None
