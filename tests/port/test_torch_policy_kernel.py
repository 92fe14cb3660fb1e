"""The policy kernel's wrapper and the policy path's surface, without JAX,
so that the `gpu` tests also run on a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" tests/port/test_torch_policy_kernel.py -q

Without a CUDA device those tests skip with the reason: the kernel has no
CPU mode. The rest checks what the wrapper does before any launch (on
`meta` tensors) and the CPU path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case

OPERANDS = ("words", "regs", "tmpl_words", "tmpl_regs")
CPU = torch.device("cpu")


def _cfg(width, height, see_through_walls):
    return EnvConfig(
        family="empty", width=width, height=height, max_steps=4 * width * height,
        see_through_walls=see_through_walls,
    )


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _case(cfg, b, t, device, seed=0):
    case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    args = [torch.from_numpy(case[k]).to(device) for k in OPERANDS]
    seeds = np.random.default_rng(seed + 1).integers(-(2**31), 2**31, (t, b)).astype(np.int32)
    return args, torch.from_numpy(seeds).to(device)


def _meta_operands(cfg, b=64, t=4):
    args, seeds = _case(cfg, b, t, "meta")
    w = tpr.eval_weights_from_params(dyadic_flax_params(0), cfg.agent_view_size, device="meta")
    return args, seeds, w


def test_wrapper_raises_off_cpu_without_cuda():
    cfg = _cfg(8, 8, True)
    args, seeds, w = _meta_operands(cfg)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tpr.run_policy_kernel(*args, seeds, w, cfg)


@pytest.mark.parametrize(
    "field,bad,error,match",
    [
        ("seeds", lambda x: x.to(torch.int64), TypeError, "seeds has dtype"),
        ("seeds", lambda x: x[:, :32], ValueError, r"seeds has shape"),
        ("words", lambda x: x.t().contiguous().t(), ValueError, "words is not contiguous"),
        ("regs", lambda x: x[:-1], ValueError, "regs has shape"),
        ("wt1", lambda x: x.float(), TypeError, "wt1 has dtype"),
        ("wt2", lambda x: x[:128], ValueError, "wt2 has shape"),
        ("wta", lambda x: x.t().contiguous().t(), ValueError, "wta is not contiguous"),
    ],
)
def test_wrapper_checks_operands_before_launch(field, bad, error, match):
    cfg = _cfg(8, 8, True)
    args, seeds, w = _meta_operands(cfg)
    ops = dict(zip(OPERANDS, args), seeds=seeds)
    if field in ops:
        ops[field] = bad(ops[field])
    else:
        w = w._replace(**{field: bad(getattr(w, field))})
    with pytest.raises(error, match=match):
        tpr.run_policy_kernel(*(ops[k] for k in OPERANDS), ops["seeds"], w, cfg)


def test_wrapper_takes_plain_twin_on_cpu():
    cfg = _cfg(9, 7, False)
    args, seeds = _case(cfg, 32, 8, CPU)
    w = tpr.eval_weights_from_params(dyadic_flax_params(0), cfg.agent_view_size, device=CPU)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg)
    assert tpr.policy_kernel_launches == before
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert got[3].dtype == torch.int32 and int(got[3].sum()) > 0  # episodes ended


@pytest.mark.parametrize("size,lanes", [((8, 8), 128), ((9, 9), 128), ((16, 16), 128), ((25, 25), 64), ((40, 40), None)])
def test_lane_block_fits_shared_memory(size, lanes):
    cfg = _cfg(*size, False)
    if lanes is None:
        with pytest.raises(ValueError, match="shared memory"):
            tpr.policy_lane_block(cfg)
    else:
        assert tpr.policy_lane_block(cfg) == lanes
        assert tpr.policy_smem_bytes(cfg, lanes) <= tpr._SMEM_LIMIT
        stages, smem = tpr.policy_plan(cfg, lanes)
        assert tpr.MIN_STAGES <= stages <= tpr.MAX_STAGES and smem == tpr.policy_smem_bytes(cfg, lanes)
        assert smem + tpr.CHUNK_BYTES > tpr._SMEM_LIMIT or stages == tpr.MAX_STAGES  # the ring takes what is left
        assert tpr.policy_plan(cfg, 2 * lanes) is None or lanes == 128


@pytest.mark.parametrize("env_id", env_list)
def test_every_ported_id_has_a_lane_block_and_plan_that_fit(env_id):
    """Every registered family (the support matrix's `FAMILY_REPS` cells
    among them): the block plan fits one block's shared memory, 128 lanes
    wherever the grids allow (all but the 19x19 grids of FourRooms,
    LockedRoom and Playground and MultiRoom's 25x25), at least MIN_STAGES
    ring slots, and Empty-8x8 takes 10."""
    cfg = make(env_id).config
    bt = tpr.policy_lane_block(cfg)
    stages, smem = tpr.policy_plan(cfg, bt)
    assert smem <= tpr._SMEM_LIMIT == 232_448
    assert bt == (64 if cfg.width * cfg.height >= 361 else 128)
    assert tpr.MIN_STAGES <= stages <= tpr.MAX_STAGES
    if env_id == "MiniGrid-Empty-8x8-v0":
        assert (bt, stages) == (128, 10)


def test_padded_features_are_whole_k_tiles():
    assert [tpr.padded_features(v) for v in (3, 5, 7)] == [192, 512, 992]


@pytest.mark.parametrize("view", [1, 4, 33])
def test_lane_block_rejects_view_sizes(view):
    with pytest.raises(ValueError, match="view size"):
        tpr.policy_lane_block(dataclasses.replace(_cfg(8, 8, False), agent_view_size=view))


def test_supported_envs_and_modes():
    """A random start without a packed generator runs regen mode through
    the family's batched `generate`, as the JAX package's policy rollouts
    do; a transition whose hook is not ported is refused."""
    empty = make("MiniGrid-Empty-8x8-v0")
    assert tpr.policy_rollout_supported(empty, "regen")
    assert tpr.policy_rollout_supported(make("MiniGrid-DistShift1-v0"), "cached")
    random_start = dataclasses.replace(empty, config=dataclasses.replace(empty.config, agent_start_pos=None))
    assert tpr.policy_rollout_supported(random_start, "cached")
    pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.ops import policy_rollout as jpr

    jempty = minigrid_tpu.make("MiniGrid-Empty-8x8-v0")
    jrandom = dataclasses.replace(jempty, config=dataclasses.replace(jempty.config, agent_start_pos=None))
    assert tpr.policy_rollout_supported(random_start, "regen") == jpr.policy_rollout_supported(jrandom, "regen")
    assert tpr.policy_rollout_supported(random_start, "regen")
    assert not tpr.policy_rollout_supported(dataclasses.replace(empty, transition="no_such_transition"), "cached")
    tpr.build_policy_eval_plain_rollout(random_start, dyadic_flax_params(0), 8, mode="regen")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpr.build_policy_eval_rollout(dataclasses.replace(empty, transition="no_such_transition"),
                                      dyadic_flax_params(0), 8)


def _sw128(row, k):
    """Byte of element (row, k < 64) in a 128-byte-swizzled chunk, as
    `csrc/policy_device.cuh::sw128_offset` computes it."""
    return row * 128 + 16 * (((k // 8) ^ row) % 8) + 2 * (k % 8)


@pytest.mark.parametrize("k,k_outer", [(980, True), (256, False), (500, True)])
def test_b_chunks_hold_each_weight_once(k, k_outer):
    """Each weight once, zeros only in the padding, and each at the byte
    the kernels' descriptors read: 16 KB chunks of 128 rows of one N half
    in the 128-byte swizzle, (K chunk, half) or (half, K chunk) ordered,
    then the tail of two 16 x 256 k slabs in 8 x 8 core matrices where 32
    of K are left (980 -> 992)."""
    w = torch.arange(1, 256 * k + 1, dtype=torch.float32).reshape(256, k)
    flat = tpr._b_chunks(w, k_outer)
    kp = -(-k // 16) * 16
    full = kp // 64 * 64
    nk = full // 64
    assert flat.numel() == 256 * kp and flat.is_contiguous()
    assert flat.numel() * 2 == (2 * nk + (1 if full < kp else 0)) * tpr.CHUNK_BYTES
    values = flat.sort().values
    assert torch.equal(values[values > 0], w.reshape(-1)) and int((values == 0).sum()) == 256 * (kp - k)
    for n, kk in [(0, 0), (9, 3), (130, 17), (255, k - 1), (37, k // 2), (200, k - 1), (7, 70), (131, 975)]:
        if kk >= k:
            continue
        h, row = divmod(n, 128)
        if kk < full:
            kc = kk // 64
            chunk = kc * 2 + h if k_outer else h * nk + kc
            byte = chunk * tpr.CHUNK_BYTES + _sw128(row, kk % 64)
        else:
            s, kr = divmod(kk - full, 16)
            byte = 2 * nk * tpr.CHUNK_BYTES + 8192 * s + 256 * (n // 8) + 128 * (kr // 8) + 16 * (n % 8) + 2 * (kr % 8)
        assert flat[byte // 2] == w[n, kk], (n, kk)


def test_actor_critic_init_is_seeded_and_round_trips():
    a = ActorCritic(7, generator=torch.Generator().manual_seed(3))
    b = ActorCritic(7, generator=torch.Generator().manual_seed(3))
    c = ActorCritic(7, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.torso_0.weight, c.torso_0.weight)
    assert a.torso_0.weight.shape == (256, 980) and not a.torso_0.bias.detach().any()
    std = float(a.torso_0.weight.detach().std())
    assert abs(std - (1 / 980) ** 0.5) < 0.05 * (1 / 980) ** 0.5  # LeCun normal
    tree = {"params": {n: {k: v.numpy() for k, v in d.items()} for n, d in a.flax_params()["params"].items()}}
    d = ActorCritic.from_flax(tree, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), d.parameters()))


def test_eval_rollout_on_cpu_runs_the_twin():
    env = make("MiniGrid-Empty-5x5-v0")
    model = ActorCritic(env.config.num_actions, generator=torch.Generator().manual_seed(0))
    carry = tfr.packed_init(env, env.reset_batch(key(0, device=CPU), 16)[0], "regen")
    step = tpr.build_policy_eval_rollout(env, model, 20, mode="regen", as_carry=True)
    before = tpr.policy_kernel_launches
    runs = [step(key(s, device=CPU), carry) for s in (1, 1, 2)]
    assert tpr.policy_kernel_launches == before
    assert torch.equal(runs[0][0].regs, runs[1][0].regs)
    assert not torch.equal(runs[0][0].regs, runs[2][0].regs)
    assert int(runs[0][1].total_steps) == 16 * 20
    rollout = tpr.build_policy_eval_rollout(env, model, 20, mode="regen")
    states, metrics = rollout(key(1, device=CPU), tfr.packed_finish(env, carry))
    assert int(metrics.obs_checksum) == int(runs[0][1].obs_checksum)
    assert torch.equal(states.agent_pos, tfr.packed_finish(env, runs[0][0]).agent_pos)


def test_eval_rollout_sees_in_place_weight_updates():
    """A module updated in place between calls (an optimiser step) is
    evaluated with its new weights by the same `step`."""
    env = make("MiniGrid-Empty-5x5-v0")
    model = ActorCritic(env.config.num_actions, generator=torch.Generator().manual_seed(0))
    carry = tfr.packed_init(env, env.reset_batch(key(0, device=CPU), 16)[0], "regen")
    step = tpr.build_policy_eval_rollout(env, model, 20, mode="regen", as_carry=True)
    before, _ = step(key(1, device=CPU), carry)
    with torch.no_grad():  # forward, always
        model.actor.bias.copy_(torch.tensor([-30.0, -30.0, 30.0, -30.0, -30.0, -30.0, -30.0]))
    after, _ = step(key(1, device=CPU), carry)
    fresh, _ = tpr.build_policy_eval_rollout(env, model, 20, mode="regen", as_carry=True)(key(1, device=CPU), carry)
    assert not torch.equal(before.regs, after.regs)
    assert torch.equal(after.words, fresh.words) and torch.equal(after.regs, fresh.regs)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "width,height,see_through_walls",
    [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, False), (25, 25, False)],
)
def test_cuda_kernel_matches_plain_twin(width, height, see_through_walls):
    """Under dyadic weights: words, registers, episodes and checksum
    byte-exact; per-lane reward sums bit-identical. The batch is ragged for
    both lane blocks (16 blocks of 128 or 32 of 64, plus 32 lanes)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(width, height, see_through_walls)
    args, seeds = _case(cfg, 2048 + 32, 32, dev, seed=width * height)
    w = tpr.eval_weights_from_params(dyadic_flax_params(5), cfg.agent_view_size, device=dev)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg)
    torch.cuda.synchronize()
    assert tpr.policy_kernel_launches == before + 1
    for name, g, x in zip(("words", "regs", "rsum", "episodes", "checksum"), got, want):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        if g.dtype == torch.float32:
            g, x = g.view(torch.int32), x.view(torch.int32)
        assert torch.equal(g, x), name


@pytest.mark.gpu
def test_cuda_eval_surface_matches_cpu_twin():
    """Empty-8x8 regen through `build_policy_eval_rollout` on the card equals
    the same call on the CPU twin, rng chain and metrics included."""
    dev = _cuda()
    env = make("MiniGrid-Empty-8x8-v0")
    params = dyadic_flax_params(6)
    out = []
    for d in (dev, CPU):
        carry = tfr.packed_init(env, env.reset_batch(key(0, device=d), 512)[0], "regen")
        step = tpr.build_policy_eval_rollout(env, params, 64, mode="regen", as_carry=True)
        out.append(step(key(3, device=d), carry))
    (ck, mk), (cp, mp) = out
    for a, b in zip(ck, cp):
        assert torch.equal(a.cpu(), b)
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        assert torch.equal(getattr(mk, name).cpu(), getattr(mp, name)), name
    # The batch sum of per-lane rewards runs in another order on the card.
    torch.testing.assert_close(mk.total_reward.cpu(), mp.total_reward, rtol=1e-6, atol=0)


def test_collect_wrapper_takes_plain_twin_on_cpu():
    cfg = _cfg(9, 7, False)
    args, seeds = _case(cfg, 32, 8, CPU)
    w = tpr.train_weights_from_params(dyadic_flax_params(0), cfg.agent_view_size, device=CPU)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg, collect=True)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg, collect=True)
    eval_out = tpr.plain_policy_rollout(*args, seeds, w, cfg)
    assert tpr.policy_kernel_launches == before
    for g, x, e in zip(got[:5], want[:5], eval_out):
        assert torch.equal(g, x) and torch.equal(g, e)
    for g, x in zip(got[5], want[5]):
        assert torch.equal(g, x)
    obs_w, actions, _, value, reward, done = got[5]
    assert tuple(obs_w.shape) == (8, 49, 32) and obs_w.dtype == torch.int32
    assert int(done.sum()) == int(got[3].sum()) and torch.equal(reward.sum(0), got[2][0])
    assert float(value.abs().max()) > 0 and int((obs_w >> 12).abs().max()) == 0  # 12-bit words


def test_collect_needs_head_row_7_for_the_critic():
    cfg = dataclasses.replace(_cfg(8, 8, True), num_actions=8)
    args, seeds, w = _meta_operands(cfg)
    with pytest.raises(ValueError, match="critic"):
        tpr.run_policy_kernel(*args, seeds, w, cfg, collect=True)
    env = make("MiniGrid-Empty-8x8-v0")
    assert tpr.policy_rollout_supported(env, "regen", collect=True)
    eight = dataclasses.replace(env, config=cfg)
    assert tpr.policy_rollout_supported(eight, "cached") and not tpr.policy_rollout_supported(eight, "cached", True)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "width,height,see_through_walls",
    [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, True), (16, 16, False)],
)
def test_cuda_collect_spill_matches_plain_twin(width, height, see_through_walls):
    """Under dyadic weights: the collect-mode spill byte-exact (every field,
    f32 rows as bits) and the carry outputs equal to the twin's and to the
    kernel's own eval mode, on a ragged batch (16 blocks of 128 + 32)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(width, height, see_through_walls)
    args, seeds = _case(cfg, 2048 + 32, 32, dev, seed=width * height + see_through_walls)
    w = tpr.train_weights_from_params(dyadic_flax_params(5), cfg.agent_view_size, device=dev)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg, collect=True)
    eval_out = tpr.run_policy_kernel(*args, seeds, w, cfg)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg, collect=True)
    torch.cuda.synchronize()
    assert tpr.policy_kernel_launches == before + 2
    names = ("words", "regs", "rsum", "episodes", "checksum")
    for name, g, e, x in zip(names, got[:5], eval_out, want[:5]):
        if g.dtype == torch.float32:
            g, e, x = g.view(torch.int32), e.view(torch.int32), x.view(torch.int32)
        assert torch.equal(g, x) and torch.equal(g, e), name
    for name, g, x in zip(("obs_w", "actions", "logp", "value", "reward", "done"), got[5], want[5]):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        if g.dtype == torch.float32:
            g, x = g.view(torch.int32), x.view(torch.int32)
        assert torch.equal(g, x), name
    assert int(want[3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("size", [9, 19])
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("env_id", ["MiniGrid-LavaGapS7-v0", "MiniGrid-FourRooms-v0", "MiniGrid-LavaCrossingS9N1-v0",
                                    "MiniGrid-SimpleCrossingS11N5-v0", "MiniGrid-LockedRoom-v0",
                                    "MiniGrid-Playground-v0"])
def test_cuda_kernel_on_the_new_families_matches_plain_twin(env_id, collect, size):
    """Under dyadic weights, on each new family's own layouts (a ragged
    batch of 2,048 + 32 lanes: 128-lane blocks at 9x9, 64-lane blocks at
    19x19) under commit rows, in eval and collect mode: byte for byte,
    f32 rows as bits, the spill on each lane's committed rows."""
    from test_torch_kernel import family_case

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, t = 2048 + 32, 24
    cfg, args = family_case(env_id, size, b, dev, seed=size + 1)
    assert tpr.policy_lane_block(cfg) == (64 if size == 19 else 128)
    rng = np.random.default_rng(size)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (t, b)).astype(np.int32)).to(dev)
    rows = np.stack([rng.integers(0, 2, b), rng.integers(0, t + 1, b), rng.random(b) < 0.1]).astype(np.int32)
    rows[:, : b // 2] = 0
    ctl = torch.from_numpy(rows).to(dev)
    to_weights = tpr.train_weights_from_params if collect else tpr.eval_weights_from_params
    w = to_weights(dyadic_flax_params(7), cfg.agent_view_size, device=dev)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg, collect=collect, ctl=ctl)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg, collect=collect, ctl=ctl)
    torch.cuda.synchronize()
    assert tpr.policy_kernel_launches == before + 1

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    for name, g, x in zip(("words", "regs", "rsum", "episodes", "checksum"), got[:5], want[:5]):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert torch.equal(bits(g), bits(x)), name
    assert torch.equal(got[-1], want[-1])  # the commit rows
    if collect:
        committed = torch.arange(t, device=dev)[:, None] < (want[-1][1] - ctl[1])[None, :]
        assert bool(committed.any())
        for name, g, x in zip(("obs_w", "actions", "logp", "value", "reward", "done"), got[5], want[5]):
            assert g.dtype == x.dtype and g.shape == x.shape, name
            m = committed if g.ndim == 2 else committed[:, None, :]
            assert torch.equal(torch.where(m, bits(g), 0), torch.where(m, bits(x), 0)), name
    assert int(want[3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [False, True])
def test_cuda_kernel_on_the_obstructed_script_matches_plain_twin(collect):
    """The policy kernel with the pickup-target hook on
    `testing.obstructed_script_case`'s doctored ObstructedMaze-1Dlhb states
    (boxed keys in front of the agents, a locked door two cells ahead), 1,024
    copies, dyadic weights, eval and collect: byte for byte against the
    plain twin."""
    from minigrid_tpu_torch.testing import OBSTRUCTED_ID, obstructed_script_case
    from minigrid_tpu_torch.utils.convert import state_from_numpy

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    env = make(OBSTRUCTED_ID)
    cfg = env.config
    s, _ = obstructed_script_case(copies=1024)
    carry = tfr.packed_init(env, state_from_numpy(s, device=dev), "cached")
    args = [carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs]
    b, t = carry.words.shape[1], 32
    seeds = torch.from_numpy(np.random.default_rng(5).integers(-(2**31), 2**31, (t, b)).astype(np.int32)).to(dev)
    to_weights = tpr.train_weights_from_params if collect else tpr.eval_weights_from_params
    w = to_weights(dyadic_flax_params(9), cfg.agent_view_size, device=dev)
    before = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, w, cfg, collect=collect, transition=env.transition)
    want = tpr.plain_policy_rollout(*args, seeds, w, cfg, collect=collect, transition=env.transition)
    torch.cuda.synchronize()
    assert tpr.policy_kernel_launches == before + 1

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    for name, g, x in zip(("words", "regs", "rsum", "episodes", "checksum"), got[:5], want[:5]):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert torch.equal(bits(g), bits(x)), name
    if collect:
        for name, g, x in zip(("obs_w", "actions", "logp", "value", "reward", "done"), got[5], want[5]):
            assert torch.equal(bits(g), bits(x)), name
