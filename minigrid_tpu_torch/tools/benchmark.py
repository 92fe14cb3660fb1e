"""The reference's benchmark on the port (counterpart of the JAX package's
root `benchmark.py`): the reset time, single-env steps and renders of one
env through the adapter's per-step path (`compat/host_env.py::HostEnv`,
which needs no gymnasium), then the batched per-env rollout
(`core/rollout.py::build_rollout`).

    python -m minigrid_tpu_torch.tools.benchmark --env-name MiniGrid-LavaGapS7-v0
    python -m minigrid_tpu_torch.tools.benchmark --device cpu --num_frames 500 --batch-size 256

Runs on the card unless `--device` names another device, and raises where
there is no card. On the card every clock read follows a
`torch.cuda.synchronize()`. Prints the device (on the card, its name and
power limit from nvidia-smi), then the reference's four lines.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import NamedTuple

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.rollout import RolloutMetrics
from minigrid_tpu_torch.core.state import EnvState


class BenchResult(NamedTuple):
    reset_ms: float  # a reset, mean over `num_resets` seeds
    frames_per_sec: float  # single-env steps a second
    render_fps: float  # full-frame renders a second (tile 32, highlight)
    batched_fps: float  # env-steps a second of the timed batched call
    states: EnvState  # the timed batched call's final states
    metrics: RolloutMetrics  # and its metrics


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--env-name", default="MiniGrid-LavaGapS7-v0")
    parser.add_argument("--num_resets", type=int, default=200)
    parser.add_argument("--num_frames", type=int, default=5000)
    parser.add_argument("--batch-size", type=int, default=8192)
    parser.add_argument("--batched-steps", type=int, default=256)
    parser.add_argument("--device", default=None, help="a torch device (default: the card)")
    return parser.parse_args(argv)


def device_line(dev: torch.device) -> str:
    """The device, and on the card its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    if dev.type != "cuda":
        return f"Device        : {dev}"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return f"Device        : {dev} ({res.stdout.strip()})"


def main(argv=None) -> BenchResult:
    args = parse_args(argv)
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.compat.host_env import HostEnv
    from minigrid_tpu_torch.core.rollout import build_rollout

    dev = prng.default_device(args.device)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    print(device_line(dev), flush=True)
    env = HostEnv(make(args.env_name), device=dev)

    # Warm up: the first reset, step and render build what they cache.
    env.reset(seed=0)
    env.step(0)
    env.render()

    t0 = clock()
    for i in range(args.num_resets):
        env.reset(seed=i)
    reset_ms = 1000 * (clock() - t0) / args.num_resets

    env.reset(seed=0)
    t0 = clock()
    for i in range(args.num_frames):
        _, _, terminated, truncated, _ = env.step(i % 3)
        if terminated or truncated:
            env.reset()
    frames_per_sec = args.num_frames / (clock() - t0)

    t0 = clock()
    for _ in range(100):
        env.render()
    render_fps = 100 / (clock() - t0)

    # The batched rollout: one call that is not timed, then a timed one
    # under `fold_in(key, 1)` from its states.
    fenv = make(args.env_name)
    rollout = build_rollout(fenv, num_steps=args.batched_steps)
    key = prng.key(0, device=dev)
    states, _ = fenv.reset_batch(key, args.batch_size)
    states, metrics = rollout(key, states)
    float(metrics.total_reward)
    t0 = clock()
    states, metrics = rollout(prng.fold_in(key, 1), states)
    _ = float(metrics.total_reward) + float(states.step_count.sum())
    batched_fps = args.batch_size * args.batched_steps / (clock() - t0)

    print(f"Env reset time: {reset_ms:.1f} ms")
    print(f"Single-env FPS: {frames_per_sec:.0f}")
    print(f"Render FPS    : {render_fps:.0f}")
    print(f"Batched FPS   : {batched_fps:,.0f} (B={args.batch_size} on {dev})", flush=True)
    return BenchResult(reset_ms, frames_per_sec, render_fps, batched_fps, states, metrics)


if __name__ == "__main__":
    main()
