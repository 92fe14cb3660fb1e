"""minigrid_tpu_torch: the PyTorch / CUDA port of `minigrid_tpu`.

The JAX package `minigrid_tpu` is the reference; this package mirrors its
module paths so each piece has an obvious counterpart, and imports only
`torch` and `numpy`. Ported so far: the packed rollout on the steady carry
surface (`ops/fused_rollout.py`) for the static-layout families Empty and
DistShift, with its step loop in one hand-written CUDA kernel
(`ops/csrc/rollout_kernel.cu`). See ROADMAP.md for what is still to come.

    import torch, minigrid_tpu_torch as mg
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops.fused_rollout import (
        build_fused_rollout, packed_init, packed_finish,
    )
    env = mg.make("MiniGrid-Empty-8x8-v0")
    states = env.reset_batch(key(0, device="cuda"), 8192)
    carry = packed_init(env, states, "regen")
    step = build_fused_rollout(env, 256, mode="regen", as_carry=True)
    carry, metrics = step(torch.Generator("cuda").manual_seed(1), carry)
    states = packed_finish(env, carry)
"""

from minigrid_tpu_torch.envs.registry import env_list, make

__all__ = ["env_list", "make"]
