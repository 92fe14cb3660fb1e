"""The rollout kernel (B1) against the bytes it must move
(`counts.state_bytes`) at 3.35 TB/s, over its device time a call in the
trace. Bytes only: no operation count is agreed that does not come from
the kernel's own instructions."""

from gpubench.harness.counts import state_bytes
from gpubench.harness.stats import roofline_pct


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s("rollout_cells16", "rollout_generic") / run.trace.calls
    if seconds <= 0:
        return None
    c, p = run.cell.config, run.cell.params
    return roofline_pct(state_bytes(c["width"] * c["height"], p["batch"], p["steps"]), 0, seconds)
