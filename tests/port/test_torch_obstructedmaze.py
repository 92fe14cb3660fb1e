"""ObstructedMaze (the 8 ids) against the JAX package.

  * The generators per id, byte for byte, against `jax.vmap(generate)` as
    `make_family_reference.py` stored it in `data/family_generators_b32.npz`
    (the deepest generators of the package: the `slow` test recomputes
    them live).
  * `roomgrid.place_in_room` / `add_object` with room indices per lane
    against the int form, lane by lane.
  * `testing.obstructed_script_case` (a doctored 1Dlhb batch: a key boxed,
    toggled out or carried in its box, the locked door, the blue ball)
    step by step through the per-env `Env.step` against the JAX package's
    `vmap(env.step)`, and through the packed `step_core` against its
    `_step_core`; then the packed rollout against the per-env rollout
    on the same script, through the reset that follows the reward.
"""

import functools

import make_family_reference as fref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.rollout import build_rollout
from minigrid_tpu_torch.envs import obstructedmaze, roomgrid
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops.packing import R_CCT
from minigrid_tpu_torch.testing import OBSTRUCTED_ID, obstructed_script_case
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CPU = torch.device("cpu")


@pytest.mark.parametrize("env_id", fref.OBSTRUCTED_IDS)
def test_generator_matches_jax_reference_file(env_id):
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", fref.OBSTRUCTED_IDS)
def test_reference_file_matches_jax_live(env_id):
    pytest.importorskip("jax")
    want, stored = fref.jax_states(env_id), fref.states(env_id)
    for name in fref.STATE_FIELDS:
        np.testing.assert_array_equal(stored[name], want[name], err_msg=f"{env_id} {name}")


def test_obstructed_layouts():
    """Locked doors with boxed keys (grey boxes holding a key of a locked
    door's colour), green blocking balls and one blue ball per lane."""
    for env_id in fref.OBSTRUCTED_IDS:
        s = fref.states(env_id)
        g = s["grid"]
        t = g[..., 0]
        extras = make(env_id).config.extras
        key_in_box = extras[1] if extras[0] == "1D" else extras[3]
        assert ((t == 6) & (g[..., 1] == obstructedmaze.BALL_COLOR)).sum(axis=(1, 2)).tolist() == [1] * fref.B
        boxes = (t == 7) & (g[..., 3] == 5)
        assert bool(boxes.any(axis=(1, 2)).all()) == bool(key_in_box), env_id
        assert ((t == 4) & (g[..., 2] == 2)).any(axis=(1, 2)).all(), env_id  # a locked door


def test_rooms_per_lane_match_the_int_form():
    """`place_in_room` and `add_object` with `(B,)` room indices give each
    lane what the int form gives it."""
    cfg = make("MiniGrid-ObstructedMaze-Full-v0").config
    b = 18
    keys = prng.split(prng.key(3, device=CPU), 3 * b).reshape(3, b, 2)
    rg = roomgrid.init(keys[0], cfg, torch.zeros((b, cfg.height, cfg.width, 5), dtype=torch.uint8) + 1)
    ii = torch.arange(b, dtype=torch.int32) % 3
    jj = (torch.arange(b, dtype=torch.int32) // 3) % 3
    cell = torch.tensor([7, 5, 0, 5, 1], dtype=torch.int32).expand(b, 5)
    got, gx, gy = roomgrid.place_in_room(rg, cfg, keys[1], ii, jj, cell)
    got, *gobj = roomgrid.add_object(got, cfg, keys[2], jj, ii)
    for lane in range(b):
        one = roomgrid.RG(*(t[lane : lane + 1] for t in rg))
        i, j = int(ii[lane]), int(jj[lane])
        want, wx, wy = roomgrid.place_in_room(one, cfg, keys[1, lane : lane + 1], i, j, cell[:1])
        want, *wobj = roomgrid.add_object(want, cfg, keys[2, lane : lane + 1], j, i)
        assert torch.equal(got.grid[lane], want.grid[0]) and (int(gx[lane]), int(gy[lane])) == (int(wx), int(wy))
        assert [int(v[lane]) for v in gobj] == [int(v[0]) for v in wobj]
        x0, y0 = i * (cfg.room_size - 1), j * (cfg.room_size - 1)
        assert x0 < int(gx[lane]) < x0 + cfg.room_size - 1 and y0 < int(gy[lane]) < y0 + cfg.room_size - 1


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax

    import minigrid_tpu
    from minigrid_tpu.ops import fused_rollout as jfr

    jenv = minigrid_tpu.make(OBSTRUCTED_ID)
    cfg = jenv.config
    hook, remap, pre = jfr._packed_hook(jenv)
    core = functools.partial(jfr._step_core, width=cfg.width, height=cfg.height, view=cfg.agent_view_size,
                             max_steps=cfg.max_steps, see_through_walls=cfg.see_through_walls, hook=hook,
                             remap_action=remap, pre_hook=pre)
    return jax.jit(jax.vmap(jenv.step)), jax.jit(core)


def _jax_state(s):
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState as JState

    return JState(**{k: jnp.asarray(v) for k, v in s.items()})


def test_script_per_env_step_matches_jax():
    """Every step of the script: states, observation, reward (rtol 1e-6)
    and flags of `Env.step` against the JAX package's per-env step."""
    jstep, _ = _jax_fns()
    s, actions = obstructed_script_case()
    env = make(OBSTRUCTED_ID)
    state, jstate = state_from_numpy(s, device=CPU), _jax_state(s)
    rewards = []
    for t, a in enumerate(actions):
        state, obs, r, te, tr = env.step(state, torch.from_numpy(a))
        jstate, jobs, jr, jte, jtr = jstep(jstate, a)
        got, want = state_to_numpy(state), {k: np.asarray(getattr(jstate, k)) for k in fref.STATE_FIELDS}
        for name in fref.STATE_FIELDS:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"step {t} {name}")
        np.testing.assert_array_equal(obs["image"].numpy(), np.asarray(jobs["image"]), err_msg=f"step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        assert te.tolist() == np.asarray(jte).tolist() and tr.tolist() == np.asarray(jtr).tolist()
        rewards.append(r.tolist())
    carried = [state_to_numpy(state)["carrying"]]
    assert rewards[-1][0] > 0 and te.tolist() == [True, False]  # lane 0 holds the ball
    assert carried[0][1].tolist() == [5, int(s["grid"][1, int(s["agent_pos"][1, 1]), 5, 1]), 0, 0]  # lane 1: the key


def test_script_packed_step_matches_jax_step_core():
    """The packed `step_core` on the same script (its template the
    doctored state, so lane 0 resets after its reward) against the JAX
    package's `_step_core`: words, registers (the carried box's contents
    included), reward, done and the obs checksum."""
    _, jcore = _jax_fns()
    s, actions = obstructed_script_case()
    env = make(OBSTRUCTED_ID)
    cfg = env.config
    carry = tfr.packed_init(env, state_from_numpy(s, device=CPU), "cached")
    args = [carry.words, carry.regs, None, carry.tmpl_words, carry.tmpl_regs]
    kw = dict(width=cfg.width, height=cfg.height, view=cfg.agent_view_size, max_steps=cfg.max_steps,
              see_through_walls=cfg.see_through_walls, **tfr.hook_kwargs(env.transition, cfg))
    seen_box = False
    for t, a in enumerate(actions):
        args[2] = torch.from_numpy(a[None])
        got = tfr.step_core(*args, **kw)
        want = jcore(*(x.numpy() for x in args))
        for name, g, w in zip(("words", "regs", "reward", "done", "obs_sum"), got, want):
            if name == "reward":
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"step {t} {name}")
        seen_box |= bool((got[1][R_CCT] == 5).any())  # a carried box holding a key
        args[0], args[1] = got[0], got[1]
    assert seen_box and float(got[2][0, 0]) > 0


def test_script_packed_rollout_matches_per_env_rollout():
    """`build_packed_plain_rollout` under the script's actions against
    `build_rollout` with a policy that plays the script, cached mode: 16
    copies, 12 steps (lane 0's copies reset after the reward)."""
    s, actions = obstructed_script_case(copies=16)
    actions = np.concatenate([actions, np.full((2, actions.shape[1]), 2, np.int32)])
    env = make(OBSTRUCTED_ID)
    it = iter(torch.from_numpy(actions))
    per_env = build_rollout(env, len(actions), policy=lambda k, obs: next(it), autoreset_mode="cached")
    packed = tfr.build_packed_plain_rollout(env, len(actions), mode="cached", actions_override=actions)
    s1, m1 = per_env(prng.key(1, device=CPU), state_from_numpy(s, device=CPU))
    s2, m2 = packed(prng.key(1, device=CPU), state_from_numpy(s, device=CPU))
    a, b = state_to_numpy(s1), state_to_numpy(s2)
    for name in fref.STATE_FIELDS:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert [int(x) for x in (m1.episodes, m1.total_steps, m1.obs_checksum)] == [
        int(x) for x in (m2.episodes, m2.total_steps, m2.obs_checksum)]
    assert int(m1.episodes) == 16
    np.testing.assert_allclose(float(m1.total_reward), float(m2.total_reward), rtol=1e-5)
