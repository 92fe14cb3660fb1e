"""The policy kernel (B2) collecting the train step's trajectory, against
the least time its work allows (`counts.b2_counts`: the state, the
weights and the trajectory spill at 3.35 TB/s, or the forward at the bf16
peak), over its device time a step in the trace. A static layout has no
commit rows."""

from gpubench.harness.counts import b2_counts
from gpubench.harness.stats import roofline_pct


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s("policy_kernel") / run.trace.calls
    if seconds <= 0:
        return None
    c, p = run.cell.config, run.cell.params
    return roofline_pct(*b2_counts(c["width"] * c["height"], c["view"], p["batch"], p["steps"]), seconds)
