"""Share of their memory roofline that the field kernels reach: the sum
of every launch's bound time (lanes x bytes a lane / HBM bandwidth,
portbench/kernels.py) over the sum of their device times in the traced
window. The lanes are recorded where the port counts each launch, so
their number has to match the port's own count of launches."""
from portbench.kernels import KERNEL_NAMES, roofline_pct


def read(ctx):
    if ctx.trace is None or ctx.lanes is None:
        return None
    for kern in KERNEL_NAMES:
        got, counted = len(ctx.lanes.get(kern, [])), ctx.launches.get(kern, 0)
        if got != counted:
            raise ValueError(f"{kern}: lanes of {got} launches recorded, "
                             f"{counted} launches counted by the port")
    return roofline_pct(ctx.lanes, ctx.trace.field_kernel_ns, ctx.peak)
