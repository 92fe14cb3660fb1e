"""minigrid_tpu_torch: the PyTorch / CUDA port of `minigrid_tpu`.

The JAX package `minigrid_tpu` is the reference; this package mirrors its
module paths so each piece has an obvious counterpart, and imports only
`torch` and `numpy`. All 70 of its env ids are ported, in twenty-two
families, with two engines:

  * the per-env engine, in plain PyTorch: `Env.reset_batch` / `reset` /
    `step` with the reference's egocentric observations (`core/obs.py`),
    each family's own transition (`core/step.py`, `envs/*.py::step`),
    auto-reset (`core/autoreset.py`), `core/rollout.py::build_rollout`
    and `parallel/mixed.py::MixedEnv`; the independent reference of
  * the packed engine on the steady carry surface: the packed rollout
    (`ops/fused_rollout.py`), its step loop in one hand-written CUDA
    kernel (`ops/csrc/rollout_kernel.cu`) with every family hook of the
    JAX package (`ops/packed_hooks.py`); in regen mode exact chunked regen
    (`ops/chunked_regen.py`) with fresh layouts from the families' packed
    generators, whose plan loops are kernels of their own
    (`ops/csrc/gen_kernel.cu`), or from their batched `generate`, packed;
    policy-in-the-loop evaluation (`ops/policy_rollout.py`,
    `models/policy.py`) in a second kernel (`ops/csrc/policy_kernel.cu`);
    the fused train step (`parallel/train.py::build_fused_train_step`):
    that kernel in collect mode spills the trajectory (on a random layout,
    merged across chunked regen's passes), a third one
    (`ops/csrc/grad_kernel.cu`) runs the actor-critic gradient pass, then
    clip + Adam; and mixed batches of member envs, one lane block each
    (`parallel/mixed.py`). `tools/` holds the Mosaic bisection probe, a
    fourth.

Every path also runs over a mesh of devices (`parallel/sharding.py`: one
device may hold several shards): the sharded rollouts and policy
evaluation (`parallel/packed.py`), the three train steps and the mixed
batches with `mesh=`, and several processes on `torch.distributed`
(`parallel/distributed.py`).

The user-facing surfaces sit on the per-env engine: `render/` (RGB
frames by atlas gather), `wrappers/` (observation wrappers and count
bonuses), `compat/` (the gymnasium adapter over a batch of one, the
class-based wrappers, and the reference's exact MT19937 layouts), and
`utils/ascii.py`, `utils/checkpoint.py`, `tools/profile.py`; the JAX
package's root scripts are `python -m minigrid_tpu_torch.tools.benchmark`,
`.run_tests` and `.manual_control`. Importing
this package registers nothing into gymnasium and loads neither
gymnasium nor matplotlib: `compat.register_all_gymnasium()` registers the
ids under the `minigrid_tpu_torch/` namespace.

Entry points make their tensors on the card unless the caller names a
device. See ROADMAP.md for what comes next.

    import torch, minigrid_tpu_torch as mg
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.rollout import build_rollout
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops.fused_rollout import packed_init, packed_finish
    from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_rollout
    env = mg.make("MiniGrid-Empty-8x8-v0")
    states, obs = env.reset_batch(key(0), 8192)  # obs["image"]: (8192, 7, 7, 3) uint8
    states, obs, reward, terminated, truncated = env.step(states, torch.full((8192,), 2, device="cuda"))
    states, metrics = build_rollout(env, 64)(key(3), states)
    carry = packed_init(env, states, "regen")
    model = ActorCritic(7, generator=torch.Generator("cuda").manual_seed(0))
    step = build_policy_eval_rollout(env, model, 256, mode="regen", as_carry=True)
    carry, metrics = step(key(1), carry)
    from minigrid_tpu_torch.parallel.train import build_fused_train_step, init_train_state
    ts = init_train_state(env)
    ts, carry, metrics = build_fused_train_step(env, 256, mode="regen")(ts, carry, key(2))
    states = packed_finish(env, carry)
"""

from minigrid_tpu_torch.core.constants import (
    COLOR_NAMES,
    COLOR_TO_IDX,
    COLORS,
    DIR_TO_VEC,
    IDX_TO_COLOR,
    IDX_TO_OBJECT,
    OBJECT_TO_IDX,
    STATE_TO_IDX,
    TILE_PIXELS,
)
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.envs.registry import env_list, make, register, registry

__version__ = "0.1.0"

__all__ = [
    "COLORS",
    "COLOR_NAMES",
    "COLOR_TO_IDX",
    "IDX_TO_COLOR",
    "OBJECT_TO_IDX",
    "IDX_TO_OBJECT",
    "STATE_TO_IDX",
    "DIR_TO_VEC",
    "TILE_PIXELS",
    "EnvState",
    "make",
    "registry",
    "register",
    "env_list",
]
