"""The multi-device dry run (counterpart of `__graft_entry__.py::
dryrun_multichip`): the same steps over the port's mesh, with the same
checks on `total_steps`.

    python -c "from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

runs on the first two visible cards; `devices=["cpu"] * 8` runs it on 8
CPU shards (the plain versions of the kernels), and `devices=["cuda:0"] *
2` on two shards of one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.ops.fused_rollout import packed_init
from minigrid_tpu_torch.parallel.packed import (
    build_sharded_policy_eval,
    build_sharded_rollout,
    gather_carry,
    shard_carry,
)
from minigrid_tpu_torch.parallel.sharding import make_env_mesh, shard_states
from minigrid_tpu_torch.parallel.train import (
    build_fused_train_step,
    build_packed_train_step,
    build_train_step,
    init_train_state,
)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Shard env batches over an `n_devices`-shard mesh (default: the first
    `n_devices` visible cards; raises without them) and run one step of
    each sharded path: the per-env and packed train steps, the sharded
    random-policy rollout (a static and a random layout, the states and
    the carry surface, at 128 and 1,024 lanes a shard), policy evaluation
    and the fused train step on random layouts. Returns the metrics it
    printed."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"{n_devices} CUDA devices needed: pass devices=['cpu'] * {n_devices} for CPU shards")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    mesh = make_env_mesh(list(devices)[:n_devices])
    n = mesh.n_env
    dev = mesh.shard_devices[0]
    env = make("MiniGrid-Empty-8x8-v0")
    key, k_env, _ = prng.split(prng.key(0, device=dev), 3)

    def batch(e, b):
        return shard_states(e.reset_batch(k_env, b)[0], mesh)

    train_state = init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    states = batch(env, 8 * n)
    train_state, states, metrics = build_train_step(env, 4, mesh=mesh)(train_state, states, key)

    pstates = batch(env, 128 * n)
    _, pmetrics = build_sharded_rollout(env, 4, mesh)(key, pstates)
    assert int(pmetrics.total_steps) == 128 * n * 4

    denv = make("MiniGrid-Empty-Random-5x5-v0")
    _, dmetrics = build_sharded_rollout(denv, 4, mesh, mode="regen")(key, batch(denv, 128 * n))
    assert int(dmetrics.total_steps) == 128 * n * 4

    _, _, ptm = build_packed_train_step(env, 4, mesh=mesh)(train_state, states, key)

    cstep = build_sharded_rollout(env, 4, mesh, mode="cached", as_carry=True)
    carry = tuple(packed_init(env, s, "cached") for s in pstates)
    for i in range(2):
        carry, cmetrics = cstep(prng.fold_in(key, i), carry)
    gather_carry(carry)
    assert int(cmetrics.total_steps) == 128 * n * 4

    big_b = 1024 * n
    bstates = batch(env, big_b)
    bstep = build_sharded_rollout(env, 32, mesh, mode="regen", as_carry=True)
    bcarry, bmetrics = bstep(key, tuple(packed_init(env, s, "regen") for s in bstates))
    assert int(bmetrics.total_steps) == big_b * 32
    _, dbig_metrics = build_sharded_rollout(denv, 32, mesh, mode="regen")(key, batch(denv, big_b))
    assert int(dbig_metrics.total_steps) == big_b * 32

    peval = build_sharded_policy_eval(env, train_state.params, 8, mesh, mode="cached")
    _, pe_metrics = peval(key, pstates)
    assert int(pe_metrics.total_steps) == 128 * n * 8

    fenv = make("MiniGrid-DoorKey-5x5-v0")
    fb = 128 * n
    fts = init_train_state(fenv, generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    fcarry = shard_carry(packed_init(fenv, fenv.reset_batch(k_env, fb)[0], "regen"), mesh)
    fts, fcarry, fmetrics = build_fused_train_step(fenv, 4, mode="regen", mesh=mesh)(fts, fcarry, key)
    assert int(fmetrics["env_steps"]) == fb * 4

    out = {
        "train": {k: float(v) for k, v in metrics.items()},
        "packed": {"steps": int(pmetrics.total_steps), "episodes": int(pmetrics.episodes),
                   "obs_checksum": int(pmetrics.obs_checksum)},
        "packed_regen_empty_random": {"steps": int(dmetrics.total_steps), "episodes": int(dmetrics.episodes),
                                      "reset_overlaps": int(dmetrics.reset_overlaps)},
        "packed_train": {k: float(v) for k, v in ptm.items()},
        "carry_surface": {"steps_per_call": int(cmetrics.total_steps)},
        "big_carry": {"steps": int(bmetrics.total_steps), "episodes": int(bmetrics.episodes)},
        "big_regen_empty_random": {"steps": int(dbig_metrics.total_steps), "episodes": int(dbig_metrics.episodes),
                                   "reset_overlaps": int(dbig_metrics.reset_overlaps)},
        "policy_eval": {"steps": int(pe_metrics.total_steps)},
        "fused_train": {"env_steps": int(fmetrics["env_steps"]), "loss": float(fmetrics["loss"])},
    }
    print("dryrun_multichip ok:", out, flush=True)
    return out
