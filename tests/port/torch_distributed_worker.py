"""Worker program of `tests/port/test_torch_distributed.py`: one process of
a two-process `torch.distributed` job of the port (imports torch and the
port only).

    python tests/port/torch_distributed_worker.py <port> <process_id> <num_processes> <out_dir>

Each process joins a gloo process group at `localhost:<port>`, takes 4 CPU
shards of the job's global mesh (`global_env_mesh`), resets only its lanes
of the global batch (`make_global_batch`), runs the sharded random-policy
rollout and sums the metrics over the processes (`psum_metrics`), then
takes one sharded fused train step (its gradient sums `all_reduce`d before
the update). It prints the summed metrics on a `METRICS` line and writes
its params, Adam's moments and its final carries to
`<out_dir>/rank<id>.npz`.
"""

import sys

import numpy as np
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops.fused_rollout import packed_init
from minigrid_tpu_torch.parallel import distributed, packed, train
from minigrid_tpu_torch.testing import dyadic_flax_params

ENV_ID = "MiniGrid-Empty-8x8-v0"
LOCAL_SHARDS = 4
LANES_PER_SHARD = 16
T = 8
TRAIN_ENV_ID = "MiniGrid-Empty-5x5-v0"
TRAIN_T = 8


def run(mesh):
    """The job's work on `mesh`: (summed rollout metrics, train state,
    final train carries)."""
    env = make(ENV_ID)
    global_b = LANES_PER_SHARD * mesh.n_global
    states, _ = distributed.make_global_batch(env, key(0, device="cpu"), global_b, mesh)
    _, metrics = packed.build_sharded_rollout(env, T, mesh, mode="regen")(key(1, device="cpu"), states)
    metrics = distributed.psum_metrics(metrics, mesh)

    tenv = make(TRAIN_ENV_ID)
    tstates, _ = distributed.make_global_batch(tenv, key(2, device="cpu"), global_b, mesh)
    carries = tuple(packed_init(tenv, s, "regen") for s in tstates)
    model = ActorCritic.from_flax(dyadic_flax_params(5), device="cpu")
    ts = train.TrainState(model, train.make_optimizer().init(train.flatten_params(model.flax_params())))
    step = train.build_fused_train_step(tenv, TRAIN_T, mode="regen", mesh=mesh)
    ts, carries, tm = step(ts, carries, key(3, device="cpu"))
    return metrics, ts, carries, tm


def main() -> int:
    port, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo", timeout_s=120)
    mesh = distributed.global_env_mesh(["cpu"] * LOCAL_SHARDS)
    info = distributed.process_info(mesh)
    assert info == {"process_index": rank, "process_count": world, "local_device_count": LOCAL_SHARDS,
                    "global_device_count": LOCAL_SHARDS * world}, info
    metrics, ts, carries, tm = run(mesh)
    print("METRICS", int(metrics.episodes), int(metrics.total_steps), int(metrics.obs_checksum),
          int(metrics.reset_overlaps), float(metrics.total_reward), int(tm["env_steps"]), float(tm["episodes"]),
          flush=True)
    np.savez(f"{out_dir}/rank{rank}.npz", params=train.flatten_params(ts.params.flax_params()).numpy(),
             mu=ts.opt_state.mu.numpy(), nu=ts.opt_state.nu.numpy(), words=packed.gather_carry(carries).words.numpy())
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
