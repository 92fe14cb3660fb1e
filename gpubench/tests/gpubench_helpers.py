"""Tiny cells of the real workload files for the CPU tests."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Per cell, the shapes a test run holds: few lanes, and enough steps that
# the checked calls hold resets (Empty's episodes end by step 256; DoorKey
# runs at 5x5, whose episodes end by step 250, where 8x8's last 640).
TINY = {
    "empty8x8.random": (dict(batch=16, steps=256, warmup_calls=0, check_within=1, reference_block=8), {}),
    "doorkey8x8.random": (
        dict(batch=16, steps=128, regen_chunk=16, warmup_calls=0, check_within=1, check_calls=2),
        dict(env_id="MiniGrid-DoorKey-5x5-v0", width=5, height=5, max_steps=250),
    ),
    # At 16 lanes the numbers swing more than at the cell's 131,072, so the
    # test holds them to limits read at this size on four seeds: the port's
    # plain step read CDF gaps of 0, loss, gradient and update gaps of at
    # most 0.00026, 0.00018 and 0.0012, and a window step's 0, 0, 0.00026
    # and 0.00007; its fp8 control at least 0.003, 0.011, 0.0087, 0.032,
    # 0.0021, 0.0034, 0.0062 and 0.019.
    "empty8x8.train": (dict(batch=16, steps=48, reference_chunk=8, trace_calls=1, check_within=2, limits={
        "cdf_gap": 0.001, "loss_gap": 0.002, "grad_gap": 0.002, "update_gap": 0.01, "window.cdf_gap": 0.001,
        "window.loss_gap": 0.001, "window.grad_gap": 0.002, "window.update_gap": 0.005}), {}),
}

RANDOM_CELLS = ("doorkey8x8.random", "empty8x8.random")


def tiny_cell(name, benchmark=None, bench_dir=None, **over):
    from gpubench.harness import spec

    cell = spec.load_cell(name, benchmark, bench_dir or spec.BENCH_DIR)
    params, config = TINY[name]
    cell.params.update(params, **over)
    cell.config.update(config)
    return cell
