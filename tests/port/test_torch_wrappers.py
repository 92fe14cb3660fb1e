"""The port's functional wrappers (`wrappers/`) against the JAX package's,
on the CPU.

  * `img_obs`, `full_obs`, `one_hot_partial_obs`, `rgb_img_obs`,
    `rgb_img_partial_obs` (tile 8) and `view_size` (5) on `testing.py`'s
    random states of three ids, against one `jax.jit(jax.vmap(...))` of
    the JAX wrappers' `observe` on the states put on one canvas
    (`surface_cases.py`), byte for byte.
  * `state_bonus` and `action_bonus` (`CountedEnv`): 8 lanes × 12 steps of
    random actions from the port's own reset states, against a `jax.vmap`
    of the JAX package's `CountedEnv.step` over per-lane count tables:
    counts and states exact, rewards to rtol 1e-6.
"""

import functools

import numpy as np
import pytest
import surface_cases as sc
import torch

from minigrid_tpu_torch import make, wrappers
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_from_numpy, state_to_numpy

CPU = torch.device("cpu")
IDS = sc.RENDER_IDS[:3]
B = 12
TILE = 8
NAMES = ("img", "full", "onehot", "rgb", "rgb_partial", "view5")


def _port_wrapped(env):
    return {"img": wrappers.img_obs(env), "full": wrappers.full_obs(env),
            "onehot": wrappers.one_hot_partial_obs(env), "rgb": wrappers.rgb_img_obs(env, TILE),
            "rgb_partial": wrappers.rgb_img_partial_obs(env, TILE), "view5": wrappers.view_size(env, 5)}


@functools.lru_cache(maxsize=None)
def _jax_observations():
    """Every JAX wrapper's observation image of all ids' states on the
    canvas (one compile, one call)."""
    import jax

    from minigrid_tpu import wrappers as jw
    from minigrid_tpu.envs.base import Env as JEnv

    jcfg = sc.jax_config(sc.canvas_config())
    base = JEnv(env_id="canvas", config=jcfg, generate=None, transition=None)
    wrapped = [jw.img_obs(base), jw.full_obs(base), jw.one_hot_partial_obs(base), jw.rgb_img_obs(base, TILE),
               jw.rgb_img_partial_obs(base, TILE), jw.view_size(base, 5)]

    def one(s):
        out = [w.observe(s, w.config) for w in wrapped]
        return [o if not isinstance(o, dict) else o["image"] for o in out]

    states = [sc.random_states(60 + i, e, B) for i, e in enumerate(IDS)]
    out = jax.jit(jax.vmap(one))(sc.jax_state(sc.joined([sc.padded(s) for s in states])))
    return states, dict(zip(NAMES, (np.asarray(o) for o in out)))


@pytest.mark.parametrize("env_id", IDS)
def test_functional_wrappers_match_jax(env_id):
    i = IDS.index(env_id)
    states, want = _jax_observations()
    env = make(env_id)
    h, w = env.config.height, env.config.width
    state = state_from_numpy(states[i], device=CPU)
    lanes = slice(i * B, (i + 1) * B)
    crops = {"full": (lanes, slice(0, w), slice(0, h)), "rgb": (lanes, slice(0, h * TILE), slice(0, w * TILE))}
    shapes = {"img": (7, 7, 3), "full": (w, h, 3), "onehot": (7, 7, 20), "rgb": (h * TILE, w * TILE, 3),
              "rgb_partial": (7 * TILE, 7 * TILE, 3), "view5": (5, 5, 3)}
    for name, wenv in _port_wrapped(env).items():
        obs = wenv.observe(state, wenv.config)
        img = obs if name == "img" else obs["image"]
        if name != "img":
            assert obs["direction"] is state.agent_dir and obs["mission"] is state.mission
        assert img.shape == (B,) + shapes[name] and img.dtype == torch.uint8, name
        np.testing.assert_array_equal(img.numpy(), want[name][crops.get(name, lanes)], err_msg=name)
    full = wrappers.full_obs(env).observe(state, env.config)["image"]
    lane = torch.arange(B)
    assert (full[lane, state.agent_pos[:, 0].long(), state.agent_pos[:, 1].long(), 0] == C.AGENT).all()
    onehot = wrappers.one_hot_partial_obs(env).observe(state, env.config)["image"]
    assert (onehot[..., :11].sum(-1) == 1).all() and (onehot[..., 11:17].sum(-1) == 1).all()


@functools.lru_cache(maxsize=None)
def _jax_counted_step(env_id):
    import jax

    import minigrid_tpu
    from minigrid_tpu import wrappers as jw

    env = minigrid_tpu.make(env_id)
    cs, ca = jw.state_bonus(env), jw.action_bonus(env)

    def both(counts_s, counts_a, state, action):
        return cs.step(counts_s, state, action), ca.step(counts_a, state, action)

    return jax.jit(jax.vmap(both)), (cs.init_counts().shape[0], ca.init_counts().shape[0])


def test_counted_env_matches_jax():
    """8 lanes × 12 steps of both bonuses from the same states."""
    env_id, b, steps = "MiniGrid-DoorKey-5x5-v0", 8, 12
    env = make(env_id)
    states, _ = env.reset_batch(key(4, device=CPU), b)
    cs, ca = wrappers.state_bonus(env), wrappers.action_bonus(env)
    jstep, sizes = _jax_counted_step(env_id)
    assert (cs.size, ca.size) == sizes
    counts = [cs.init_counts(b, device=CPU), ca.init_counts(b, device=CPU)]
    jcounts = [np.zeros((b, n), np.int32) for n in sizes]
    jstate = sc.jax_state(state_to_numpy(states))
    port_state = {"s": states, "a": states}
    actions = np.random.default_rng(0).integers(0, 7, size=(steps, b)).astype(np.int32)
    for t in range(steps):
        a = torch.from_numpy(actions[t])
        (jcs, js, _, jr_s, jte, _), (jca, _, _, jr_a, _, _) = jstep(jcounts[0], jcounts[1], jstate, actions[t])
        jcounts = [np.asarray(jcs), np.asarray(jca)]
        for tag, cenv, c, jr in (("s", cs, counts[0], jr_s), ("a", ca, counts[1], jr_a)):
            c, port_state[tag], obs, r, te, _ = cenv.step(c, port_state[tag], a)
            np.testing.assert_array_equal(c.numpy(), jcounts[0 if tag == "s" else 1], err_msg=f"{tag} step {t}")
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0, err_msg=f"{tag} step {t}")
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
        got = state_to_numpy(port_state["s"])
        for name in STATE_FIELDS:
            np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
        jstate = js
    assert counts[0].sum() == b * steps and counts[1].sum() == b * steps
    assert (counts[0].max() > 1) and float(r.min()) < 1.0


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_counts", "seeded_counts"])
def test_counted_env_off_the_grid_matches_jax(seeded):
    """Hand-made DoorKey-5x5 lanes whose agent stands off the grid: at (5,
    4) (state index 25 and action index >= 700: both past the table, so no
    count moves), at (-1, 0) (index -1 wraps to 24), at (-1, -5) (index
    -26 wraps to -1: past the table) and one in bounds. Three steps of
    actions that leave the pose where it is, from zero counts (a dropped
    lane reads an unvisited edge cell and pays `inf`) and from random
    counts (it pays the edge cell's bonus): counts and rewards equal the
    JAX package's vmapped `CountedEnv.step`, `inf` included."""
    env_id = "MiniGrid-DoorKey-5x5-v0"
    env = make(env_id)
    states, _ = env.reset_batch(key(7, device=CPU), 4)
    states = states.replace(agent_pos=torch.tensor([[5, 4], [-1, 0], [-1, -5], [1, 1]], dtype=torch.int32))
    cs, ca = wrappers.state_bonus(env), wrappers.action_bonus(env)
    jstep, sizes = _jax_counted_step(env_id)
    g = np.random.default_rng(5)
    jcounts = [g.integers(1, 9, size=(4, n)).astype(np.int32) if seeded else np.zeros((4, n), np.int32)
               for n in sizes]
    counts = [torch.from_numpy(c.copy()) for c in jcounts]
    jstate = sc.jax_state(state_to_numpy(states))
    port_state = {"s": states, "a": states}
    for t, action in enumerate((0, 6, 1)):
        a = np.full(4, action, np.int32)
        (jcs, js, _, jr_s, _, _), (jca, _, _, jr_a, _, _) = jstep(jcounts[0], jcounts[1], jstate, a)
        jcounts, jstate = [np.asarray(jcs), np.asarray(jca)], js
        for i, (tag, cenv, jr) in enumerate((("s", cs, jr_s), ("a", ca, jr_a))):
            counts[i], port_state[tag], _, r, _, _ = cenv.step(counts[i], port_state[tag], torch.from_numpy(a))
            np.testing.assert_array_equal(counts[i].numpy(), jcounts[i], err_msg=f"{tag} step {t}")
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0, err_msg=f"{tag} step {t}")
            np.testing.assert_array_equal(np.isinf(r.numpy()), np.isinf(np.asarray(jr)), err_msg=f"{tag} step {t}")
    assert state_to_numpy(port_state["s"])["agent_pos"].tolist() == [[5, 4], [-1, 0], [-1, -5], [1, 1]]
    if not seeded:  # lanes 0 and 2 counted nowhere and pay `inf`

        assert [int(c.sum()) for c in counts] == [2 * 3, 2 * 3]
        assert np.isinf(np.asarray(jr_s)[[0, 2]]).all() and np.isinf(np.asarray(jr_a)[[0, 2]]).all()


def test_counted_env_first_visits():
    """The JAX test's contract: the first visit pays 1, the second 1/sqrt(2)."""
    env = make("MiniGrid-Empty-8x8-v0")
    cenv = wrappers.state_bonus(env)
    counts = cenv.init_counts(1, device=CPU)
    state, _ = env.reset(key(0, device=CPU))
    counts, state, _, r, *_ = cenv.step(counts, state, torch.tensor([0]))
    assert float(r[0]) == 1.0
    counts, state, _, r, *_ = cenv.step(counts, state, torch.tensor([0]))
    assert float(r[0]) == pytest.approx(1.0 / np.sqrt(2))


def test_counts_default_to_the_card():
    cenv = wrappers.action_bonus(make("MiniGrid-Empty-5x5-v0"))
    if torch.cuda.is_available():
        assert cenv.init_counts(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cenv.init_counts(4)


@pytest.mark.gpu
def test_wrappers_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    env = make("MiniGrid-DoorKey-8x8-v0")
    states, _ = env.reset_batch(key(2, device=CPU), 256)
    card = state_from_numpy(state_to_numpy(states), device=dev)
    for name, wenv in _port_wrapped(env).items():
        a, b = wenv.observe(states, wenv.config), wenv.observe(card, wenv.config)
        a, b = (a, b) if name == "img" else (a["image"], b["image"])
        assert torch.equal(b.cpu(), a), name
    for cenv in (wrappers.state_bonus(env), wrappers.action_bonus(env)):
        c_cpu, c_card = cenv.init_counts(256, device=CPU), cenv.init_counts(256, device=dev)
        s_cpu, s_card = states, card
        for t in range(8):
            a = torch.full((256,), t % 3, dtype=torch.int32)
            c_cpu, s_cpu, _, r_cpu, *_ = cenv.step(c_cpu, s_cpu, a)
            c_card, s_card, _, r_card, *_ = cenv.step(c_card, s_card, a.to(dev))
            assert torch.equal(c_card.cpu(), c_cpu) and torch.equal(r_card.cpu().view(torch.int32), r_cpu.view(torch.int32))


@pytest.mark.gpu
def test_host_env_on_the_card_matches_the_cpu():
    """The adapter's per-step path (`compat/host_env.py`, no gymnasium) on
    the card and on the CPU: observations, rewards, flags, the hash, the
    ASCII view, the frame and the flat observation at every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from minigrid_tpu_torch.compat.host_env import HostEnv, flat_obs

    envs = [HostEnv(make("MiniGrid-DoorKey-8x8-v0"), device=d) for d in ("cuda", "cpu")]
    outs = [e.reset(seed=3)[0] for e in envs]
    for a in (2, 1, 2, 2, 0, 3, 5, 2, 2, 1, 2, 4, 2):
        steps = [e.step(a) for e in envs]
        np.testing.assert_array_equal(steps[0][0]["image"], steps[1][0]["image"])
        assert steps[0][1:] == steps[1][1:] and steps[0][0]["mission"] == steps[1][0]["mission"]
        assert envs[0].hash() == envs[1].hash() and str(envs[0]) == str(envs[1])
        np.testing.assert_array_equal(flat_obs(steps[0][0]), flat_obs(steps[1][0]))
    np.testing.assert_array_equal(envs[0].render(tile_size=32), envs[1].render(tile_size=32))
    assert outs[0]["mission"] == outs[1]["mission"]
