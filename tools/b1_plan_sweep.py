#!/usr/bin/env python3
"""The rollout kernel (B1) under each of its launch plans, timed on the
card at the shapes of `chip_smoke.py`'s B1 rows.

    python3 tools/b1_plan_sweep.py

For each case (Empty-8x8 B = 2^21, T = 256; KeyCorridorS6R3 hook + commit
rows, B = 32,768, T = 128; MultiRoom-N4-S5 commit rows, T = 96;
DynamicObstacles-16x16 B = 262,144, T = 32; Fetch-5x5-N2 B = 262,144,
T = 256; DoorKey-8x8 commit rows, B = 262,144, T = 32; RedBlueDoors-8x8
hook + commit rows, B = 32,768, T = 32), from `reset_batch(key(0))` in
cached mode under random actions: the plan `rollout_plan` picks with the
card's occupancy, then every single plan it chooses from (threads a lane
and lanes a block), each the mean of 3 launches by CUDA events, with the
plan's resident warps. The cases at B = 32,768 and DynamicObstacles are
also held against `plain_rollout`, byte for byte. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (env id, B, T, commit rows, held against the plain version)
CASES = (
    ("MiniGrid-Empty-8x8-v0", 2_097_152, 256, False, False),
    ("MiniGrid-KeyCorridorS6R3-v0", 32_768, 128, True, True),
    ("MiniGrid-MultiRoom-N4-S5-v0", 32_768, 96, True, True),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", 262_144, 32, False, True),
    ("MiniGrid-Fetch-5x5-N2-v0", 262_144, 256, False, False),
    ("MiniGrid-DoorKey-8x8-v0", 262_144, 32, True, False),
    ("MiniGrid-RedBlueDoors-8x8-v0", 32_768, 32, True, True),
)


def time_ms(fn, reps=3):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr

    if not torch.cuda.is_available():
        print("b1_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for env_id, b, t, ctl, check in CASES:
        env = make(env_id)
        carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), b)[0], "cached")
        actions = torch.from_numpy(np.random.default_rng(0).integers(0, 7, (t, b)).astype(np.int32)).to(dev)
        ctl_rows = torch.zeros((3, b), dtype=torch.int32, device=dev) if ctl else None
        args = (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, actions, env.config, env.transition,
                ctl_rows)
        ms, got = time_ms(lambda: fr.run_rollout_kernel(*args))
        line = f"{env_id} B={b} T={t} ctl={ctl}: {ms:.6f} ms, plan {fr.last_rollout_plan}"
        if check:
            want = fr.plain_rollout(*args)
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g.view(torch.int32),
                                                                                   w.view(torch.int32))]
            line += f"; against plain_rollout: differing outputs {bad or 'none'}, episodes {int(want[3].sum())}"
            if bad:
                raise RuntimeError(f"{env_id}: the rollout kernel differs from its plain version")
        print(line, flush=True)
        saved = (fr.THREADS_PER_LANE, dict(fr.LANE_BLOCKS))
        try:
            for tpl in saved[0]:
                for lanes in saved[1][16, tpl]:
                    fr.THREADS_PER_LANE = (tpl,)
                    fr.LANE_BLOCKS[16, tpl] = (lanes,)
                    fr._card_plan.cache_clear()
                    ms, _ = time_ms(lambda: fr.run_rollout_kernel(*args))
                    print(f"    {tpl} threads a lane, {lanes} lanes a block: {ms:.6f} ms, plan {fr.last_rollout_plan}",
                          flush=True)
        finally:
            fr.THREADS_PER_LANE, fr.LANE_BLOCKS = saved[0], saved[1]
            fr._card_plan.cache_clear()
        del carry, args, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
