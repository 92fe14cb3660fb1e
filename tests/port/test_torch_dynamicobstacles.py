"""DynamicObstacles, the only stochastic transition, in the port against the
JAX package on the CPU:

  * each generator byte for byte per registered id, against
    `jax.vmap(generate)` (B = 32) as `make_family_reference.py` stored it
    in `data/family_generators_b32.npz` (the `slow` test recomputes it
    live), with its configuration and transition;
  * the plain pre-hook against `_make_pre_dynamicobstacles` on the same
    packed words and registers (`testing.hooked_packed_case`: n distinct
    obstacles, one in the forward cell of half the lanes), at 5x5, 8x8 and
    16x16: words, registers and `not_clear` byte for byte;
  * `plain_rollout` against `build_packed_xla_rollout(mode="cached")`
    under forced actions 0-6, two calls of T = 12, on those states and on
    the family's own `reset_batch` states (carries, `episodes` and
    `obs_checksum` byte-exact, `total_reward` to rtol 1e-6, ROADMAP.md
    §C); regen mode from `data/regen_train_reference.npz`
    (`do_random_regen`, `make_regen_train_reference.py`);
  * hand-made cases, one step each, against the JAX package's `_step_core`:
    a forward move whose blocking obstacle walks away (the penalty still
    comes: `not_clear` is read before the walk), an obstacle boxed in (it
    stays), step counts where `step_count·n + i` wraps int32, and lanes
    that freeze under the commit rows on a step in which their obstacles
    moved (the step leaves no trace).

Kernel against plain version: test_torch_hook_kernels.py (on a card).
"""

import dataclasses
import functools

import make_family_reference as fref
import make_regen_train_reference as rref
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import minigrid_tpu  # noqa: E402
from minigrid_tpu.ops import fused_rollout as jfr  # noqa: E402
from minigrid_tpu.ops import packed_hooks as jph  # noqa: E402
from minigrid_tpu_torch import env_list, make  # noqa: E402
from minigrid_tpu_torch.core.prng import key, split  # noqa: E402
from minigrid_tpu_torch.envs import dynamicobstacles as tdo  # noqa: E402
from minigrid_tpu_torch.ops import fused_rollout as tfr  # noqa: E402
from minigrid_tpu_torch.ops import packed_hooks as tph  # noqa: E402
from minigrid_tpu_torch.ops.packing import R_AUX, R_SC  # noqa: E402
from minigrid_tpu_torch.testing import hooked_packed_case  # noqa: E402
from test_torch_hooks import assert_step_outputs as _assert_step_outputs  # noqa: E402
from minigrid_tpu_torch.utils.convert import carry_to_numpy  # noqa: E402

IDS = fref.DYNOBST_IDS
TRANSITION = "dynamicobstacles"
B = 64
T = 12


def test_ids_and_selection_are_the_jax_packages():
    from minigrid_tpu.envs import dynamicobstacles as jdo

    assert IDS == [e for e in env_list if e.startswith("MiniGrid-Dynamic-Obstacles-")]
    assert tdo.WALK_OFFSETS == jdo.WALK_OFFSETS and tdo.BALL_CELL == jdo.BALL_CELL
    rng = np.random.default_rng(0)
    valid = rng.random((9, 256)) < 0.3
    valid[:, :16] = False  # boxed in
    xs, ys = rng.integers(0, 9, (9, 256)), rng.integers(0, 9, (9, 256))
    ox, oy, u = rng.integers(0, 9, 256), rng.integers(0, 9, 256), rng.integers(0, 2**31, 256)
    got = tdo.select_walk_target([torch.from_numpy(v) for v in valid], torch.from_numpy(u),
                                 [torch.from_numpy(x) for x in xs], [torch.from_numpy(y) for y in ys],
                                 torch.from_numpy(ox), torch.from_numpy(oy))
    want = jax.jit(jdo.select_walk_target)(list(valid), u, list(xs), list(ys), ox, oy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("env_id", IDS)
def test_generator_and_registration_match_jax(env_id):
    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(jenv.config)
    assert env.transition == TRANSITION and env.config.num_actions == 3
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", IDS)
def test_generator_reference_file_matches_jax(env_id):
    fref.assert_port_matches(env_id, fref.jax_states(env_id))


def _case(env_id, seed=3, b=B):
    cfg = make(env_id).config
    case = hooked_packed_case(seed, TRANSITION, cfg.width, cfg.height, b, cfg.max_steps, cfg.n_obstacles)
    return cfg, case


@functools.lru_cache(maxsize=None)
def _jax_pre(env_id):
    return jax.jit(jph.PRE_HOOK_FACTORIES[minigrid_tpu.make(env_id).transition](minigrid_tpu.make(env_id).config))


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-5x5-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0",
                                    "MiniGrid-Dynamic-Obstacles-16x16-v0"])
def test_pre_hook_matches_jax(env_id):
    cfg, case = _case(env_id)
    pre = tph.PRE_HOOK_FACTORIES[TRANSITION](cfg)
    got = pre(torch.from_numpy(case["words"]), torch.from_numpy(case["regs"]))
    want = _jax_pre(env_id)(case["words"], case["regs"])
    for name, g, w in zip(("words", "regs", "not_clear"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    n = cfg.n_obstacles
    moved = (got[1][R_AUX : R_AUX + 2 * n] != torch.from_numpy(case["regs"][R_AUX : R_AUX + 2 * n])).any(0)
    assert int(moved.sum()) > B // 2 and got[2].any() and not got[2].all()


def _actions(seed, t=T, b=B):
    return np.random.default_rng(seed).integers(0, 7, (t, b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_cached(env_id, seed):
    env = minigrid_tpu.make(env_id)
    return jax.jit(jfr.build_packed_xla_rollout(env, T, mode="cached", as_carry=True, actions_override=_actions(seed)))


def _two_cached_calls(env, carry, seed):
    """Two cached-mode calls of the plain path and the JAX package's from
    one carry, compared; returns the port's metrics."""
    jstep = _jax_cached(env.env_id, seed)
    step = tfr.build_packed_plain_rollout(env, T, mode="cached", as_carry=True, actions_override=_actions(seed))
    jc = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(carry).items()})
    out = []
    for i in range(2):
        carry, m = step(None, carry)
        jc, jm = jstep(jax.random.PRNGKey(0), jc)
        for name, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
        for name in ("episodes", "obs_checksum", "reset_overlaps"):
            assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        out.append(m)
    return out


def _carry(case, b=B):
    return tfr.PackedCarry(*(torch.from_numpy(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs")),
                           rng=split(key(1, device="cpu"), b))


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-5x5-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0"])
def test_plain_rollout_matches_jax_cached(env_id):
    env = make(env_id)
    _, case = _case(env_id)
    got = _two_cached_calls(env, _carry(case), 0)
    assert sum(float(m.total_reward) for m in got) < 0  # collisions
    states, _ = env.reset_batch(key(9, device="cpu"), B)
    _two_cached_calls(env, tfr.packed_init(env, states, "cached"), 1)


def test_plain_rollout_matches_jax_regen_from_file():
    rref.assert_port_random_case("do_random_regen")


# --------------------------------------------------------------------------
# Hand-made single steps against the JAX package's `_step_core`
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(env_id, max_steps, with_ctl):
    jenv = minigrid_tpu.make(env_id)
    cfg = dataclasses.replace(jenv.config, max_steps=max_steps)
    hook, remap, pre = jfr._packed_hook(dataclasses.replace(jenv, config=cfg))
    step = functools.partial(jfr._step_core, width=cfg.width, height=cfg.height, view=cfg.agent_view_size,
                             max_steps=max_steps, see_through_walls=cfg.see_through_walls, hook=hook,
                             remap_action=remap, pre_hook=pre)
    if with_ctl:
        return jax.jit(lambda w, r, a, tw, tr, ctl: step(w, r, a, tw, tr, chunk_ctl=ctl, chunk_len=4))
    return jax.jit(step)


def _one_step(env_id, case, actions, max_steps=None, ctl=None):
    """One step of `step_core` and of the JAX package's `_step_core` on the
    same arrays, compared; returns the port's outputs."""
    cfg = make(env_id).config
    max_steps = max_steps or cfg.max_steps
    cfg = dataclasses.replace(cfg, max_steps=max_steps)
    args = [case[k] for k in ("words", "regs")] + [actions] + [case[k] for k in ("tmpl_words", "tmpl_regs")]
    kw = tfr.hook_kwargs(TRANSITION, cfg)
    got = tfr.step_core(*(torch.from_numpy(x) for x in args), width=cfg.width, height=cfg.height,
                        view=cfg.agent_view_size, max_steps=max_steps, see_through_walls=cfg.see_through_walls,
                        **kw, **({} if ctl is None else dict(chunk_ctl=torch.from_numpy(ctl), chunk_len=4)))
    jstep = _jax_step(env_id, max_steps, ctl is not None)
    want = jstep(*args) if ctl is None else jstep(*args, ctl)
    _assert_step_outputs(got, want)
    return got


def _placed(env_id, b, seed, agent, spots):
    """The family's own states (cached carry) with every agent at `agent`
    facing right and obstacle i at `spots[i]`, the step counts spread."""
    env = make(env_id)
    carry = tfr.packed_init(env, env.reset_batch(key(seed, device="cpu"), b)[0], "cached")
    st = tfr.packed_finish(env, carry)
    grid, aux = st.grid.clone(), st.aux.clone()
    lanes = torch.arange(b)
    for i in range(env.config.n_obstacles):
        grid[lanes, aux[:, 2 * i + 1].long(), aux[:, 2 * i].long()] = torch.tensor([1, 0, 0, 0, 0], dtype=torch.uint8)
    for i, (x, y) in enumerate(spots):
        grid[:, y, x] = torch.tensor(tdo.BALL_CELL, dtype=torch.uint8)
        aux[:, 2 * i], aux[:, 2 * i + 1] = x, y
    st = st.replace(grid=grid, aux=aux, agent_pos=torch.tensor(agent, dtype=torch.int32).expand(b, 2).clone(),
                    agent_dir=torch.zeros(b, dtype=torch.int32), step_count=torch.arange(b, dtype=torch.int32) % 50)
    words, regs = tfr._pack_rolled(env.config, st)
    return {"words": words.numpy(), "regs": regs.numpy(), "tmpl_words": carry.tmpl_words.numpy(),
            "tmpl_regs": carry.tmpl_regs.numpy()}


def test_collision_counts_the_cell_blocked_before_the_walk():
    """Obstacle 0 blocks the agent's forward cell and always walks away
    (staying is never a candidate): a forward move still costs -1 and
    ends the episode."""
    env_id = "MiniGrid-Dynamic-Obstacles-5x5-v0"
    case = _placed(env_id, B, 2, (1, 1), [(2, 1), (1, 3)])
    pre = tph.PRE_HOOK_FACTORIES[TRANSITION](make(env_id).config)
    _, walked, not_clear = pre(torch.from_numpy(case["words"]), torch.from_numpy(case["regs"]))
    assert bool(not_clear.all()) and bool(((walked[R_AUX] != 2) | (walked[R_AUX + 1] != 1)).all())
    _, _, reward, done, _ = _one_step(env_id, case, np.full((1, B), 2, np.int32))
    assert bool((reward == -1.0).all()) and bool(done.all())


def test_boxed_in_obstacle_stays():
    """Agent at (2, 1); obstacle 0 at (1, 1) with obstacles 1 and 2 at
    (1, 2) and (2, 2): every cell of obstacle 0's box is a wall, the agent
    or another obstacle, so it stays; the others move."""
    env_id = "MiniGrid-Dynamic-Obstacles-6x6-v0"
    case = _placed(env_id, B, 3, (2, 1), [(1, 1), (1, 2), (2, 2)])
    regs = _one_step(env_id, case, np.zeros((1, B), np.int32))[1]
    assert bool((regs[R_AUX] == 1).all()) and bool((regs[R_AUX + 1] == 1).all())
    assert bool((regs[R_AUX + 2 : R_AUX + 6] != torch.from_numpy(case["regs"][R_AUX + 2 : R_AUX + 6])).any(0).all())


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-5x5-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"])
def test_step_counts_where_the_walk_counter_wraps(env_id):
    cfg, case = _case(env_id, seed=5)
    n = cfg.n_obstacles
    # step_count·n + i crosses 2**31 (and wraps int32) for i < n.
    case["regs"][R_SC] = 2**31 // n - 4 + np.arange(B) % 8
    got = _one_step(env_id, case, np.random.default_rng(1).integers(0, 7, (1, B)).astype(np.int32),
                    max_steps=2**31 - 1)
    assert not bool(got[3].all())


def test_a_lane_frozen_on_a_walked_step_leaves_no_trace():
    """Under the commit rows with the template consumed, the lanes whose
    step ends an episode (half face an obstacle and move forward) freeze:
    the walk their step made is discarded with the rest of it."""
    env_id = "MiniGrid-Dynamic-Obstacles-8x8-v0"
    cfg, case = _case(env_id, seed=7)
    rng = np.random.default_rng(7)
    ctl = np.stack([np.ones(B), rng.integers(0, 2, B), np.zeros(B)]).astype(np.int32)
    words, regs, _, done, _, ctl2 = _one_step(env_id, case, np.full((1, B), 2, np.int32), ctl=ctl)
    frozen = ctl2[2].bool()
    assert 0 < int(frozen.sum()) < B and not bool(done[0, frozen].any())
    assert torch.equal(words[:, frozen], torch.from_numpy(case["words"])[:, frozen])
    assert torch.equal(regs[:, frozen], torch.from_numpy(case["regs"])[:, frozen])
    n = cfg.n_obstacles
    walked = tph.PRE_HOOK_FACTORIES[TRANSITION](cfg)(torch.from_numpy(case["words"]), torch.from_numpy(case["regs"]))[1]
    assert bool((walked[R_AUX : R_AUX + 2 * n, frozen] != regs[R_AUX : R_AUX + 2 * n, frozen]).any(0).all())
