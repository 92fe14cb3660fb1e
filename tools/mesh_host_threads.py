"""One host thread a card against `parallel/sharding.py::map_shards`
(every shard from the calling thread), timed over every visible card at
`chip_smoke.py` phase 20's cells.

    python tools/mesh_host_threads.py [--pairs N]

Designs: `threads` (each card's shards in a host thread of its own,
joined before the sum), `switch` (the same with the interpreter's switch
interval at `SWITCH_S` while they run) and `sequential` (`map_shards`).
Every call's integers (carry sums, metrics) are checked equal across the
designs. Cells, over M1 (one shard a card): 20a's sharded rollout
(Empty-8x8 regen, B = 2^21, T = 256), 20b's policy evaluation (Empty-8x8
cached, B = 2^21), 20c's fused train step (KeyCorridorS6R3 regen, B =
32,768, chunk 32) and 20e's config 5 cached and regen (32,768 lanes a
member). Each design runs once to warm every card, then threads, switch,
sequential, sequential, switch, threads, `--pairs` times, beside the
unsharded call on card 0. Prints each call's seconds, each design's median
and env-steps/s, and the cards' names and power limits. Needs more than
one card to differ.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MIXED_IDS = ("MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-FourRooms-v0")
SWITCH_S = 1e-4


def threads(mesh, fn):
    """Each distinct card's shards in a host thread of its own (in shard
    order within a card), the results in shard order."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    def run(dev):
        with torch.cuda.device(dev):
            return {i: fn(i) for i, d in enumerate(mesh.shard_devices) if d == dev}

    results = {}
    with ThreadPoolExecutor(max_workers=len(mesh.distinct_devices)) as pool:
        for fut in [pool.submit(run, dev) for dev in mesh.distinct_devices]:
            results.update(fut.result())
    return [results[i] for i in range(mesh.n_env)]


def switch(mesh, fn):
    old = sys.getswitchinterval()
    sys.setswitchinterval(SWITCH_S)
    try:
        return threads(mesh, fn)
    finally:
        sys.setswitchinterval(old)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0, out


def cells(mesh, dev):
    """`{name: (lanes·steps, call over the mesh, the unsharded call on
    card 0)}`; a call over the mesh returns integers (sums of the carries,
    the metrics) that must not change from one design to the other."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.parallel import train as tr

    def carry_ints(carries, *counts):
        c = pk.gather_carry(carries, dev)
        return [int(x.to(torch.int64).sum()) for x in c] + [int(n) for n in counts]

    def rollout_ints(carries, m):
        return carry_ints(carries, m.episodes, m.obs_checksum)

    out = {}
    env = make("MiniGrid-Empty-8x8-v0")
    b, t = 2_097_152, 256
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), b)[0], "regen")
    shards = pk.shard_carry(carry, mesh)
    k = key(3000, device=dev)
    step = pk.build_sharded_rollout(env, t, mesh, mode="regen", as_carry=True)
    one = fr.build_fused_rollout(env, t, mode="regen", as_carry=True)
    out["20a rollout"] = (b * t, lambda: rollout_ints(*step(k, shards)), lambda: one(k, carry))

    pcarry = fr.packed_init(env, env.reset_batch(key(1, device=dev), b)[0], "cached")
    pshards = pk.shard_carry(pcarry, mesh)
    model = ActorCritic(env.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    peval = pk.build_sharded_policy_eval(env, model, t, mesh, mode="cached", as_carry=True)
    pone = pr.build_policy_eval_rollout(env, model, t, mode="cached", as_carry=True)
    out["20b policy"] = (b * t, lambda: rollout_ints(*peval(k, pshards)), lambda: pone(k, pcarry))

    kc = make("MiniGrid-KeyCorridorS6R3-v0")
    kb = 32_768
    states = kc.reset_batch(key(0, device=dev), kb)[0]
    g = torch.Generator(device=dev).manual_seed(21)
    back = torch.randint(1, 2 * t + 1, (kb,), generator=g, device=dev, dtype=torch.int32)
    states = states.replace(step_count=(kc.config.max_steps - back).to(torch.int32))
    kcarry = fr.packed_init(kc, states, "regen")
    kshards = pk.shard_carry(kcarry, mesh)
    kmodel = ActorCritic(kc.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    ts = tr.TrainState(kmodel, tr.make_optimizer().init(tr.flatten_params(kmodel.flax_params())))
    kstep = tr.build_fused_train_step(kc, t, mode="regen", regen_chunk=32, mesh=mesh)
    kone = tr.build_fused_train_step(kc, t, mode="regen", regen_chunk=32)

    def train_call():
        _, c, m = kstep(ts, kshards, k)
        return carry_ints(c, m["episodes"], m["env_steps"])

    out["20c KeyCorridorS6R3 train"] = (kb * t, train_call, lambda: kone(ts, kcarry, k))

    members = [make(e) for e in MIXED_IDS]
    for mode in ("cached", "regen"):
        mcarries = tuple(fr.packed_init(e, e.reset_batch(key(30 + i, device=dev), 32_768)[0], mode)
                         for i, e in enumerate(members))
        msharded = tuple(pk.shard_carry(c, mesh) for c in mcarries)
        mstep = mixed.build_packed_mixed_rollout(MIXED_IDS, t, mode=mode, as_carry=True, mesh=mesh)
        mone = mixed.build_packed_mixed_rollout(MIXED_IDS, t, mode=mode, as_carry=True)

        def mixed_call(mstep=mstep, msharded=msharded):
            finals, m = mstep(k, msharded)
            return sum((carry_ints(f) for f in finals), rollout_ints(finals[0], m)[-2:])

        out[f"20e config 5 {mode}"] = (65_536 * t, mixed_call, lambda mone=mone, mcarries=mcarries: mone(k, mcarries))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mesh_host_threads: no CUDA device", file=sys.stderr)
        return 2
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.parallel import sharding

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = "; ".join(cards)
    dev = torch.device("cuda", 0)
    mesh = sharding.make_env_mesh()
    print(f"mesh {[str(d) for d in mesh.shard_devices]} [{card}]", flush=True)
    designs = {"threads": threads, "switch": switch, "sequential": sharding.map_shards}
    readings = {}
    for name, (steps, call, unsharded) in cells(mesh, dev).items():
        unsharded()
        one_s, _ = timed(unsharded)
        want = None
        for design in designs:  # warm-up: every card, every design
            sharding.map_shards = designs[design]
            _, got = timed(call)
            want = got if want is None else want
            if got != want:
                raise RuntimeError(f"{name}: {design} differs from threads")
        order = (list(designs) + list(designs)[::-1]) * args.pairs
        for design in order:
            sharding.map_shards = designs[design]
            secs, got = timed(call)
            if got != want:
                raise RuntimeError(f"{name}: {design} differs")
            readings.setdefault(name, {}).setdefault(design, []).append(secs)
        med = {d: statistics.median(v) for d, v in readings[name].items()}
        print(f"{name}: unsharded on cuda:0 {one_s:.4f} s ({steps / one_s:.6e} env-steps/s); "
              + "; ".join(f"{d} {', '.join(f'{x:.4f}' for x in readings[name][d])} s, median {med[d]:.4f} "
                          f"({steps / med[d]:.6e} env-steps/s)" for d in designs)
              + f"; results equal [{card}]", flush=True)
    sharding.map_shards = designs["sequential"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
