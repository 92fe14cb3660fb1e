"""minigrid_tpu_torch: the PyTorch / CUDA port of `minigrid_tpu`.

The JAX package `minigrid_tpu` is the reference; this package mirrors its
module paths so each piece has an obvious counterpart, and imports only
`torch` and `numpy`. Ported so far, on the steady carry surface: the
packed rollout (`ops/fused_rollout.py`), its step loop in one
hand-written CUDA kernel (`ops/csrc/rollout_kernel.cu`), for 62 ids of
twenty families: Empty, DistShift, LavaGap, FourRooms, DoorKey, Lava and
Simple Crossing, DynamicObstacles, Memory, Fetch, GoToDoor, GoToObject,
PutNear, RedBlueDoors, MultiRoom, LockedRoom, Playground, Unlock,
UnlockPickup, BlockedUnlockPickup and KeyCorridor (every family hook of
the JAX package in the kernel, `ops/packed_hooks.py`). In regen mode the random-layout families
run exact chunked regen (`ops/chunked_regen.py`) with fresh layouts from
their packed generators, whose plan loops are kernels of their own
(`ops/csrc/gen_kernel.cu`), or from their batched `generate`, packed;
for all of these families,
policy-in-the-loop evaluation (`ops/policy_rollout.py`,
`models/policy.py`) in a second one (`ops/csrc/policy_kernel.cu`), and
the fused train step (`parallel/train.py::build_fused_train_step`): that
kernel in collect mode spills the trajectory (on a random layout, merged
across chunked regen's passes), a third one (`ops/csrc/grad_kernel.cu`)
runs the actor-critic gradient pass, then clip + Adam; and mixed batches
of member envs, one lane block each (`parallel/mixed.py`, on one
device). `tools/` holds the
Mosaic bisection probe, a fourth. Entry points make their tensors on the
card unless the caller names a device. See ROADMAP.md for what is still
to come.

    import torch, minigrid_tpu_torch as mg
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops.fused_rollout import packed_init, packed_finish
    from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_rollout
    env = mg.make("MiniGrid-Empty-8x8-v0")
    carry = packed_init(env, env.reset_batch(key(0), 8192), "regen")
    model = ActorCritic(7, generator=torch.Generator("cuda").manual_seed(0))
    step = build_policy_eval_rollout(env, model, 256, mode="regen", as_carry=True)
    carry, metrics = step(key(1), carry)
    from minigrid_tpu_torch.parallel.train import build_fused_train_step, init_train_state
    ts = init_train_state(env)
    ts, carry, metrics = build_fused_train_step(env, 256, mode="regen")(ts, carry, key(2))
    states = packed_finish(env, carry)
"""

from minigrid_tpu_torch.envs.registry import env_list, make

__all__ = ["env_list", "make"]
