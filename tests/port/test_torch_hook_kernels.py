"""On a card: the rollout kernel (B1) and the policy kernel (B2) under the
family hooks ported with their families (Fetch, GoToDoor, GoToObject,
PutNear, RedBlueDoors; Memory with its remap, Unlock, DynamicObstacles
with its pre-hook and remap), and B2's `<64, collect, ctl, no hook>`
instantiation that DoorKey's train step reaches, against their plain
versions, byte for byte (reward sums bit for bit):

  * on `testing.hooked_packed_case` states (the hook's events planted in
    front of each agent; DynamicObstacles' obstacle in the forward cell)
    at each family's grid, the first action the one that fires the hook,
    then actions from -1 to 7; B1 with and without commit rows, B2 in eval
    and collect mode with and without them (RedBlueDoors at 6x6 and 16x8,
    Memory at S7 and S17 and DynamicObstacles at 8x8 and 16x16, all in
    128-lane blocks); the hook must change the plain version's outcome
    against the base step;
  * from each family's `packed_init` carry on the card, regen mode (the
    template refresh packs the batched `generate`): the random-policy and
    policy-evaluation rollouts and the collecting rollouts of DoorKey-5x5
    and DynamicObstacles-5x5, kernels against `build_*_plain_rollout`.

The JAX package is not imported, so the file runs on a machine with a card
and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/port/test_torch_hook_kernels.py -q

Their plain versions are held against the JAX package on the CPU in
test_torch_hooks.py and test_torch_doorkey.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_train_regen import compare_policy_runs

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.testing import dyadic_flax_params, hooked_packed_case

# Transition -> (an id of its family, the action that fires the hook).
HOOKED = {
    "fetch": ("MiniGrid-Fetch-8x8-N3-v0", 3),
    "gotodoor": ("MiniGrid-GoToDoor-8x8-v0", 6),
    "gotoobject": ("MiniGrid-GoToObject-8x8-N2-v0", 6),
    "putnear": ("MiniGrid-PutNear-8x8-N3-v0", 4),
    "redbluedoors": ("MiniGrid-RedBlueDoors-8x8-v0", 5),
    "memory": ("MiniGrid-MemoryS7-v0", 2),
    "unlock": ("MiniGrid-Unlock-v0", 5),
    "dynamicobstacles": ("MiniGrid-Dynamic-Obstacles-16x16-v0", 2),
}
POLICY_CASES = [(t, e) for t, (e, _) in HOOKED.items()] + [
    ("redbluedoors", "MiniGrid-RedBlueDoors-6x6-v0"),
    ("memory", "MiniGrid-MemoryS17Random-v0"),
    ("dynamicobstacles", "MiniGrid-Dynamic-Obstacles-8x8-v0"),
]
B, T = 1024, 24


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the policy twin's f32 GEMMs in full f32
    return torch.device("cuda")


def _case(transition, env_id, dev, seed=11):
    cfg = dataclasses.replace(make(env_id).config, max_steps=12)
    case = hooked_packed_case(seed, transition, cfg.width, cfg.height, B, cfg.max_steps, cfg.n_obstacles or 0)
    rng = np.random.default_rng(seed + 2)
    ctl = np.stack([rng.integers(0, 2, B), rng.integers(0, T + 1, B), rng.random(B) < 0.1]).astype(np.int32)
    ctl[:, : B // 2] = 0  # half the lanes start the pass fresh
    args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
    return cfg, args, torch.from_numpy(ctl).to(dev), rng


def _differ(got, want):
    return [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g.view(torch.int32), w.view(torch.int32))]


@pytest.mark.gpu
@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("transition", sorted(HOOKED))
def test_cuda_rollout_kernel_hook_matches_plain(transition, ctl):
    dev = _cuda()
    env_id, fire = HOOKED[transition]
    cfg, args, ctl_in, rng = _case(transition, env_id, dev)
    actions = rng.integers(-1, 8, (T, B)).astype(np.int32)
    actions[0] = fire
    actions = torch.from_numpy(actions).to(dev)
    kw = dict(ctl=ctl_in if ctl else None)
    launches = tfr.rollout_kernel_launches
    got = tfr.run_rollout_kernel(*args, actions, cfg, transition, **kw)
    assert tfr.rollout_kernel_launches == launches + 1
    want = tfr.plain_rollout(*args, actions, cfg, transition, **kw)
    assert _differ(got, want) == []
    base = tfr.plain_rollout(*args, actions, cfg, "base", **kw)
    assert not torch.equal(want[2], base[2]) or not torch.equal(want[3], base[3])  # the hook fired


@pytest.mark.gpu
@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("transition,env_id", POLICY_CASES + [("base", "MiniGrid-DoorKey-8x8-v0")])
def test_cuda_policy_kernel_hook_matches_plain(transition, env_id, collect, ctl):
    """Every new B2 instantiation: the five hooks at their families' lane
    blocks, and the hookless one at 64 lanes (collect under the commit
    rows is the new one; the other three were built before)."""
    dev = _cuda()
    cfg, args, ctl_in, rng = _case("fetch" if transition == "base" else transition, env_id, dev)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (T, B)).astype(np.int32)).to(dev)
    weights = (tpr.train_weights_from_params if collect else tpr.eval_weights_from_params)(
        dyadic_flax_params(5, num_actions=cfg.num_actions), cfg.agent_view_size, device=dev)
    kw = dict(collect=collect, ctl=ctl_in if ctl else None, transition=transition)
    launches = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, weights, cfg, **kw)
    assert tpr.policy_kernel_launches == launches + 1
    want = tpr.plain_policy_rollout(*args, seeds, weights, cfg, **kw)
    assert compare_policy_runs(got, want, kw["ctl"]) == {}
    assert int(want[3].sum()) > 0


def _same(a, b):
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y) for x, y in zip(a, b))


def _family_carry(env_id, dev, max_steps=5, b=B):
    env = make(env_id)
    env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))
    return env, tfr.packed_init(env, env.reset_batch(prng.key(3, device=dev), b)[0], "regen")


FAMILY_IDS = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-Random-6x6-v0"] + [e for e, _ in HOOKED.values()] + [
    "MiniGrid-UnlockPickup-v0", "MiniGrid-BlockedUnlockPickup-v0", "MiniGrid-Dynamic-Obstacles-Random-6x6-v0"]


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", FAMILY_IDS)
def test_cuda_regen_rollouts_match_plain_from_a_family_carry(env_id):
    """Random policy and policy evaluation in regen mode, chunk 8, T = 16,
    `max_steps` cut to 5 (deferred resets): kernels against the plain
    paths, carries and metrics byte for byte."""
    dev = _cuda()
    env, carry = _family_carry(env_id, dev)
    acts = np.random.default_rng(4).integers(0, 7, (16, B)).astype(np.int32)
    runs = [build(env, 16, mode="regen", regen_chunk=8, as_carry=True, actions_override=acts)(None, carry)
            for build in (tfr.build_fused_rollout, tfr.build_packed_plain_rollout)]
    assert _same(runs[0][0], runs[1][0]) and _same(runs[0][1], runs[1][1])
    assert int(runs[0][1].reset_overlaps) > 0
    params = dyadic_flax_params(6, num_actions=env.config.num_actions)
    runs = [build(env, params, 16, mode="regen", regen_chunk=8, as_carry=True)(prng.key(5, device=dev), carry)
            for build in (tpr.build_policy_eval_rollout, tpr.build_policy_eval_plain_rollout)]
    assert _same(runs[0][0], runs[1][0]) and _same(runs[0][1], runs[1][1])
    assert int(runs[0][1].episodes) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0"])
def test_cuda_doorkey_train_rollout_matches_plain(env_id):
    """The collecting rollout in regen mode of DoorKey-5x5 (B2 `<64,
    collect, ctl, no hook>` and the packed batched `generate`) and of
    DynamicObstacles-5x5 (the pre-hook, 3 actions), chunk 8, against
    `build_fused_train_plain_rollout`: carry, metrics and merged
    trajectory byte for byte."""
    dev = _cuda()
    env, carry = _family_carry(env_id, dev)
    weights = tpr.train_weights_from_params(dyadic_flax_params(7, num_actions=env.config.num_actions), 7, device=dev)
    runs = [build(env, 16, mode="regen", regen_chunk=8)(weights, prng.key(8, device=dev), carry)
            for build in (tpr.build_fused_train_rollout, tpr.build_fused_train_plain_rollout)]
    (cg, tg, mg), (cw, tw, mw) = runs
    assert _same(cg, cw) and _same(mg, mw) and _same(tg, tw)
    assert int(mg.reset_overlaps) > 0
