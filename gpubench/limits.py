"""Readings for the limits of a cell's comparison: for each seed, the
cell's set-up and the calls its check needs, then the numbers the check
compares for the program and for each control (the reference so changed
in the program's place). One JSON line a seed. Not run by the benchmark.

    python3 gpubench/limits.py --workload <cell> --seeds 1 2 3 [--controls reward_bf16 stale] [--fault half_batch]

`--fault` plants a fault in the program before set-up (`FAULTS`).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _exchange(train):
    """A step over a mesh adds only the first shard's gradient and loss
    sums, as if the exchange between the cards were left out."""
    add = train._add_in_order
    return "_add_in_order", lambda parts, device: add(parts[:1], device)


def _half_batch(train):
    """The whole batch collected, but the loss, its gradient and the
    step's totals taken over the first half of each shard's lanes and
    scaled to the batch (the mean over the rest)."""
    grad_sums = train._kernel_grad_sums

    def half(w, traj, num_actions, denom, *args, **kw):
        h = traj[4].shape[-1] // 2
        gw, sums, reward_sum, episodes = grad_sums(w, tuple(x[..., :h].contiguous() for x in traj), num_actions,
                                                   denom / 2, *args, **kw)
        return gw, sums * 2, reward_sum * 2, episodes * 2

    return "_kernel_grad_sums", half


FAULTS = {"exchange": _exchange, "half_batch": _half_batch}


def plant(fault: str, set_attr=setattr) -> None:
    """Plants `fault` in the port's train step (`set_attr(module, name,
    value)`, so a test can undo it)."""
    from minigrid_tpu_torch.parallel import train

    set_attr(train, *FAULTS[fault](train))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench.harness import spec

    cell = spec.load_cell(args.workload)
    if args.fault:
        plant(args.fault)
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        mode = spec.mode_module(cell).Mode(cell, seed, device)
        for i in range(mode.min_calls):
            mode.call(i, lambda _piece: None)
        t1 = time.perf_counter()
        out = mode.readings(tuple(args.controls))
        row = {"workload": args.workload, "seed": seed, "fault": args.fault, "setup_and_calls_s": t1 - t0,
               "check_s": time.perf_counter() - t1}
        for who, checks in out.items():
            row[who or "program"] = {c.name: c.value for c in checks}
            row[who or "program"].update(getattr(mode, "info", {}).get(who or "program", {}))
        print(json.dumps(row), flush=True)
        del mode
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
