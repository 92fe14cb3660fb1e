"""The benchmark of `minigrid_tpu_torch` on NVIDIA cards: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout. Set-up builds or loads the port's
kernels (the build cache is `build/minigrid_tpu_torch/` in the checkout),
makes the cell's batch and weights on the card from `--seed` and warms up
the cell's shapes; then it calls the program for `--seconds` seconds,
each call ending at `torch.cuda.synchronize()`; with `--trace 1` it marks
the program's pieces with CUDA events and traces a few more calls under
`torch.profiler`. Then it holds what the window produced against the
plain reference (`gpubench/reference/`), prints each compared number
beside its limit as the last lines of standard error, and prints one JSON
line: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `checks`.

Exits 3 without a result where the cell's cards are missing, and 1 where
the run loaded JAX or the JAX package (looked for once the comparison and
the metric readers have run, and again just before the line is printed).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "gpubench"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 3
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    line = json.dumps(result)
    runner.refuse_forbidden()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
