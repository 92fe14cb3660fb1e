#!/usr/bin/env python3
"""A work model of the connect kernel (B4) and the room-chain kernel (B5)
under their launch designs, from the plain versions' counts on the CPU.

    python3 tools/gen_work_model.py [--batch B]

On the inputs of `chip_smoke.py`'s phase 9b (KeyCorridorS6R3's generator
plan) and phase 11a (MultiRoom-N4-S5 and N6), B lanes (default 32,768),
it counts the Threefry blocks a warp issues, one warp-instruction stream
for all its threads, so that a warp costs what its slowest lane costs:

  * B5, one thread a lane (the earlier design): an attempt issues 2 blocks
    for the retry chain and 5 a key row the lazy loop draws; a warp holds
    32 lanes. A group of eight threads a lane, one per try: an attempt
    issues 2 + 5 (the first room's rows, one a thread) + 25 for each room
    it tries (every try of the room at once); a warp holds 4 lanes.
  * B4, W threads a lane with a window of W draws: a window issues W
    blocks of the chain and 20 for the draws' randints; a warp holds 32 / W
    lanes and runs windows until its slowest lane has stopped ("static"),
    or, as the kernel does, hands the threads of its stopped lanes to the
    others, each of n running lanes taking 32 / p threads, p the least
    power of two at least n ("regrouped").

It prints, per design, the mean and the mean of the warp's most serial
blocks a lane, and the blocks all warps issue; for B5 also the tries the
lazy loop draws a room it tries. A count of work, not a time: the card's
time is `tools/gen_kernel_sweep.py`'s. Runs on the CPU in about two
minutes at B = 32,768.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _warps(per_lane, lanes_a_warp):
    """Per warp, its most serial blocks of any lane."""
    n = len(per_lane) // lanes_a_warp * lanes_a_warp
    return per_lane[:n].reshape(-1, lanes_a_warp).max(axis=1)


def _report(name, per_lane, lanes_a_warp):
    warp = _warps(per_lane, lanes_a_warp)
    print(f"  {name}: serial blocks a lane mean {per_lane.mean():.1f}, mean of the {lanes_a_warp}-lane warp's most "
          f"{warp.mean():.1f}; blocks all warps issue {warp.sum():.4e}", flush=True)


def chain_model(env_id, b):
    import torch

    import chip_smoke
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.envs import multiroom

    cfg = make(env_id).config
    keys, nr, _, max_attempts = chip_smoke.mr_chain_inputs(cfg, b, torch.device("cpu"))
    key = (keys.T.to(torch.int64) & prng.MASK32).contiguous()
    nr = nr[0].to(torch.int64)
    count = torch.zeros(b, dtype=torch.int64)
    attempts = torch.zeros(b, dtype=torch.int64)
    old = torch.zeros(b, dtype=torch.float64)
    new = torch.zeros(b, dtype=torch.float64)
    tries = rooms = 0
    while True:  # plain_mr_chain's loop, keeping each attempt's count and rows
        idx = torch.nonzero((count < nr) & (attempts < max_attempts)).flatten()
        if idx.numel() == 0:
            break
        children = prng.split(key[idx], 2)
        key[idx] = children[:, 0]
        cand, used = multiroom._try_chain(children[:, 1], cfg, nr[idx])
        c = cand.count.to(torch.int64)
        tried = torch.clamp(c - 1, min=0) + ((c >= 1) & (c < nr[idx])).to(torch.int64)  # rooms placed, and the one that failed
        old[idx] += 2 + 5 * used.to(torch.float64)
        tries += int((used - 4).sum()) // 5
        rooms += int(tried.sum())
        new[idx] += 2 + 5 + 25 * tried.to(torch.float64)
        count[idx] = torch.maximum(count[idx], c)
        attempts[idx] += 1
    print(f"B5 {env_id}, B={b}: attempts mean {attempts.double().mean():.4f}, max {int(attempts.max())}; the lazy "
          f"loop's tries a room tried {tries / rooms:.4f}", flush=True)
    _report("one thread a lane", old.numpy(), 32)
    _report("eight threads a lane", new.numpy(), 4)


def connect_model(b):
    import numpy as np
    import torch

    import chip_smoke
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.ops import gen_kernel as gk

    args = chip_smoke.kc_connect_inputs(make("MiniGrid-KeyCorridorS6R3-v0").config, b, torch.device("cpu"))
    draws = gk.plain_connect_plan(*args)[2][0].numpy().astype(np.int64)
    print(f"B4 KeyCorridorS6R3 generator plan, B={b}: draws mean {draws.mean():.4f}, max {int(draws.max())}",
          flush=True)
    for w in (1, 2, 4, 8):
        lanes = 32 // w
        static = (draws // w + 1) * (w + 20)  # windows to the stop, the stop's own included
        regrouped = []
        for start in range(0, len(draws), lanes):
            left = [int(d) for d in draws[start:start + lanes] if d > 0]
            blocks = 0
            while left:
                p = 1
                while p < len(left):
                    p *= 2
                width = 32 // p
                blocks += width + 20
                left = [d - width for d in left if d > width]
            regrouped.append(blocks)
        warp = _warps(static, lanes)
        print(f"  W={w}: static: mean of the {lanes}-lane warp's most {warp.mean():.1f} blocks, all warps "
              f"{warp.sum():.4e}; regrouped: all warps {float(np.sum(regrouped)):.4e}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32_768)
    opts = parser.parse_args()
    import torch

    torch.set_num_threads(4)
    connect_model(opts.batch)
    for env_id in ("MiniGrid-MultiRoom-N4-S5-v0", "MiniGrid-MultiRoom-N6-v0"):
        chain_model(env_id, opts.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
