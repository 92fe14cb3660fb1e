"""The gradient kernel (B3, its G1 and G2 passes) against the least time
its work allows (`counts.b3_counts`), over its device time a step in the
trace."""

from gpubench.harness.counts import b3_counts
from gpubench.harness.stats import roofline_pct


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s("grad_g1_kernel", "grad_g2_kernel") / run.trace.calls
    if seconds <= 0:
        return None
    c, p = run.cell.config, run.cell.params
    return roofline_pct(*b3_counts(c["view"], p["batch"], p["steps"]), seconds)
