"""Policy-in-the-loop evaluation of the port against the JAX package's
`ops/policy_rollout.py` and `models/policy.py`, on the same numpy inputs.

Tolerances, with their reasons:
  * `random_bits`, `hash_u31`, the feature permutation and the bf16 weight
    layout: bit for bit.
  * Logits under weights on a sparse dyadic grid (`dyadic_flax_params`):
    bit for bit. Every f32 sum is then exact in any order; the test checks
    that itself by recomputing the logits in float64.
  * Logits and the forward under flax-initialised weights: rtol = atol =
    0.05, the JAX package's own bound for the same comparison
    (tests/test_policy_rollout.py), set by the f32 summation order before
    the bf16 roundings.
  * Sampling on identical logits and seeds: byte-exact actions.
  * The whole eval rollout under dyadic weights against
    `build_policy_eval_rollout(backend="xla")`: every integer of the carry,
    the states and the metrics byte-exact; `total_reward` to rtol 1e-6 (the
    batch-sum order differs, as in test_torch_rollout.py).

Each JAX reference runs through one cached `jax.jit`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.core import prng as jprng
from minigrid_tpu.core.state import EnvState as JaxEnvState
from minigrid_tpu.models.policy import ActorCritic as JaxActorCritic
from minigrid_tpu.ops import fused_rollout as jfr
from minigrid_tpu.ops import policy_rollout as jpr
from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, carry_to_numpy, state_to_numpy

VIEW = 7
NUM_ACTIONS = 7
B_VIEWS = 256
B_IMAGES = 64
CPU = torch.device("cpu")


def _bits16(t):
    return t.view(torch.int16).numpy()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _views():
    """`(vw, vis)` int32 numpy views of random 8x8 states with doors, keys,
    boxes and occluding walls."""
    cfg = EnvConfig(family="empty", width=8, height=8, max_steps=256, see_through_walls=False)
    case = random_packed_case(11, 8, 8, B_VIEWS, cfg.max_steps)
    vw, vis = tfr.obs_core(
        torch.from_numpy(case["words"]), torch.from_numpy(case["regs"]),
        width=8, height=8, view=VIEW, see_through_walls=False,
    )
    return vw.numpy(), vis.numpy()


def _images():
    rng = np.random.default_rng(5)
    # Values past each channel's width included: they match no one-hot row.
    hi = np.array([13, 7, 4])
    return (rng.integers(0, 1 << 16, size=(B_IMAGES, VIEW, VIEW, 3)) % hi).astype(np.uint8)


def _sample_inputs():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(8, 256)).astype(np.float32)
    logits[7:] = -1e9
    seeds = rng.integers(-(2**31), 2**31, size=(1, 256)).astype(np.int32)
    return logits, seeds


@functools.lru_cache(maxsize=None)
def _jax_policy_refs():
    """One jit: flax init, both weight conversions, both logits, the flax
    forward and the sampler."""
    model = JaxActorCritic(num_actions=NUM_ACTIONS)
    vw, vis = _views()
    logits_in, seeds = _sample_inputs()

    @jax.jit
    def refs(key, vw, vis, images, logits_in, seeds, dyadic):
        params = model.init(key, jnp.zeros((1, VIEW, VIEW, 3), jnp.uint8))
        w_flax = jpr.eval_weights_from_params(params, VIEW)
        w_dy = jpr.eval_weights_from_params(dyadic, VIEW)
        return dict(
            params=params,
            w_flax=w_flax,
            w_dy=w_dy,
            logits_flax=jpr.policy_logits(vw, vis, w_flax, VIEW),
            logits_dy=jpr.policy_logits(vw, vis, w_dy, VIEW),
            apply=model.apply(params, images),
            actions=jpr.sample_categorical(logits_in, seeds, NUM_ACTIONS),
        )

    out = refs(jax.random.PRNGKey(0), vw, vis, _images(), logits_in, seeds, dyadic_flax_params(1))
    return _np_tree(out)


def test_random_bits_and_hash_u31_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint64).astype(np.uint32)
    k0, k1, ctr = rng.integers(-(2**31), 2**31, size=(3, 10_000)).astype(np.int32)
    k0[:3] = [-5, 3, 2**31 - 1]

    @jax.jit
    def ref(keys, k0, k1, ctr):
        bits = jax.vmap(lambda k: jax.random.bits(k, (40, 250), jnp.uint32))(keys)
        return bits, jprng.hash_u31(k0, k1, ctr)

    want_bits, want_hash = (np.asarray(x) for x in ref(keys, k0, k1, ctr))
    for i in range(2):
        kt = torch.from_numpy(keys[i].astype(np.int64))
        monkeypatch.setattr(prng, "_BITS_CHUNK", 3_001)  # chunk edges inside the draw
        got = prng.random_bits(kt, (40, 250))
        monkeypatch.undo()
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want_bits[i])
        got32 = prng.random_bits(kt, (40, 250), dtype=torch.int32)
        np.testing.assert_array_equal(got32.numpy(), want_bits[i].view(np.int32))
    got = prng.hash_u31(torch.from_numpy(k0), torch.from_numpy(k1), torch.from_numpy(ctr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_hash)


@pytest.mark.parametrize("view", [3, 5, 7])
def test_feature_permutation_matches_jax(view):
    np.testing.assert_array_equal(tpr._feature_permutation(view), jpr._feature_permutation(view))


@pytest.mark.parametrize("which", ["flax", "dyadic"])
def test_eval_weights_match_jax(which):
    refs = _jax_policy_refs()
    params = refs["params"] if which == "flax" else dyadic_flax_params(1)
    want = refs["w_flax"] if which == "flax" else refs["w_dy"]
    from_tree = tpr.eval_weights_from_params(params, VIEW, device=CPU)
    from_module = tpr.eval_weights_from_params(ActorCritic.from_flax(params, device=CPU), VIEW)
    for got in (from_tree, from_module):
        for name, g, w in zip(tpr.EvalWeights._fields, got, want):
            assert tuple(g.shape) == w.shape, name
            if g.dtype == torch.bfloat16:
                np.testing.assert_array_equal(_bits16(g), w.view(np.int16), err_msg=name)
            else:
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_actor_critic_forward_matches_flax_apply():
    refs = _jax_policy_refs()
    model = ActorCritic.from_flax(refs["params"], device=CPU)
    assert [n for n, _ in model.named_children()] == ["torso_0", "torso_1", "actor", "critic"]
    logits, value = model(torch.from_numpy(_images()))
    want_logits, want_value = refs["apply"]
    assert logits.dtype == torch.float32 and logits.shape == want_logits.shape
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(value.detach().numpy(), want_value, rtol=0.05, atol=0.05)


def _logits_f64(vw, vis, w):
    """`policy_logits` in float64, with the same bf16 roundings."""
    bf = lambda x: np.asarray(x).astype(jnp.bfloat16).astype(np.float64)
    f64 = lambda t: t.double().numpy()
    rows = []
    for chan, width in zip(((vw & 15) * vis, ((vw >> 4) & 15) * vis, ((vw >> 8) & 15) * vis), (11, 6, 3)):
        rows += [chan == v for v in range(width)]
    feats = np.concatenate(rows).astype(np.float64)
    h1 = np.maximum(bf(bf(f64(w.wt1) @ feats) + f64(w.b1)), 0)
    h2 = np.maximum(bf(bf(f64(w.wt2) @ h1) + f64(w.b2)), 0)
    return f64(w.wta) @ h2 + f64(w.ba)


def test_policy_logits_match_jax():
    refs = _jax_policy_refs()
    vw, vis = _views()
    args = (torch.from_numpy(vw), torch.from_numpy(vis))
    got = tpr.policy_logits(*args, tpr.eval_weights_from_params(refs["params"], VIEW, device=CPU), VIEW)
    np.testing.assert_allclose(got.numpy(), refs["logits_flax"], rtol=0.05, atol=0.05)
    assert float(got[NUM_ACTIONS:].max()) < -1e8  # pad rows never win the draw

    w = tpr.eval_weights_from_params(dyadic_flax_params(1), VIEW, device=CPU)
    got = tpr.policy_logits(*args, w, VIEW)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), refs["logits_dy"].view(np.int32))
    exact = _logits_f64(vw, vis, w)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), exact)
    assert len(np.unique(got.numpy()[:NUM_ACTIONS], axis=1)) > 1  # the views steer the logits


def test_sampling_matches_jax():
    logits, seeds = _sample_inputs()
    got = tpr.sample_categorical(torch.from_numpy(logits), torch.from_numpy(seeds), NUM_ACTIONS)
    assert got.dtype == torch.int32 and got.shape == (1, 256)
    np.testing.assert_array_equal(got.numpy(), _jax_policy_refs()["actions"])
    assert len(np.unique(got.numpy())) == NUM_ACTIONS
    _, logp = tpr.sample_categorical_with_logp(torch.from_numpy(logits), torch.from_numpy(seeds), NUM_ACTIONS)
    p = torch.softmax(torch.from_numpy(logits[:NUM_ACTIONS]).double(), dim=0)
    np.testing.assert_allclose(logp.numpy()[0], np.log(p.numpy()[got.numpy()[0], np.arange(256)]), rtol=1e-5)


ROLLOUT_B = 128
CASES = [
    ("MiniGrid-Empty-8x8-v0", "cached", 48),
    ("MiniGrid-Empty-5x5-v0", "regen", 64),  # step counts near max_steps: truncation resets
]


def _jax_rollout(env_id, mode, steps, states_np, seed):
    env = minigrid_tpu.make(env_id)
    params = dyadic_flax_params(2)

    @jax.jit
    def run(key, states):
        step = jpr.build_policy_eval_rollout(env, params, steps, mode=mode, backend="xla", as_carry=True)
        carry0 = jfr.packed_init(env, states, mode)
        carry, metrics = step(key, carry0)
        return carry0, carry, metrics, jfr.packed_finish(env, carry)

    states = JaxEnvState(**{f: jnp.asarray(a) for f, a in states_np.items()})
    return _np_tree(run(jax.random.PRNGKey(seed), states))


def _port_states(env, mode, seed):
    states, _ = env.reset_batch(prng.key(seed, device=CPU), ROLLOUT_B)
    if mode == "regen":
        rng = np.random.default_rng(seed)
        sc = rng.integers(0, env.config.max_steps, size=ROLLOUT_B).astype(np.int32)
        states = states.replace(step_count=torch.from_numpy(sc))
    return states


@pytest.mark.parametrize("env_id,mode,steps", CASES)
def test_eval_rollout_matches_jax_xla_twin(env_id, mode, steps):
    env = make(env_id)
    seed = steps
    states = _port_states(env, mode, seed)
    jcarry0, jcarry, jmetrics, jfinal = _jax_rollout(env_id, mode, steps, state_to_numpy(states), seed)

    carry0 = tfr.packed_init(env, states, mode)
    step = tpr.build_policy_eval_rollout(env, dyadic_flax_params(2), steps, mode=mode, as_carry=True)
    carry, metrics = step(prng.key(seed, device=CPU), carry0)
    final = state_to_numpy(tfr.packed_finish(env, carry))

    for name, got in carry_to_numpy(carry0).items():
        np.testing.assert_array_equal(got, getattr(jcarry0, name), err_msg=f"packed_init {name}")
    for name, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, getattr(jcarry, name), err_msg=f"carry {name}")
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(final[name], getattr(jfinal, name), err_msg=f"state {name}")
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        g = getattr(metrics, name)
        assert g.dtype == torch.int32 and int(g) == int(getattr(jmetrics, name)), name
    np.testing.assert_allclose(float(metrics.total_reward), float(jmetrics.total_reward), rtol=1e-6)
    assert int(metrics.total_steps) == ROLLOUT_B * steps
    if mode == "regen":
        assert int(metrics.episodes) >= ROLLOUT_B // 2  # the regen rng chain ran


@pytest.mark.parametrize("env_id", ["MiniGrid-MemoryS7-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0"])
def test_eval_rollout_matches_jax_on_the_remapped_families(env_id):
    """MemoryS7 (pickup acts as toggle) and DynamicObstacles-5x5 (the
    pre-hook; 3 actions, so the weights' head has 3 actor rows), cached
    mode, two calls of T = 24 from the port's own carry, step counts spread
    so that episodes end: carries and integer metrics byte-exact,
    `total_reward` to rtol 1e-6. The JAX package runs from that carry and
    so compiles no generator."""
    env = make(env_id)
    params = dyadic_flax_params(2, num_actions=env.config.num_actions)
    states = _port_states(env, "regen", 3)  # `_port_states` spreads the step counts in "regen"
    carry = tfr.packed_init(env, states, "cached")
    jstep = jax.jit(jpr.build_policy_eval_rollout(minigrid_tpu.make(env_id), params, 24, mode="cached",
                                                  backend="xla", as_carry=True))
    step = tpr.build_policy_eval_rollout(env, params, 24, mode="cached", as_carry=True)
    jc = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(carry).items()})
    episodes = 0
    for i in range(2):
        carry, m = step(prng.key(40 + i, device=CPU), carry)
        jc, jm = jstep(jax.random.PRNGKey(40 + i), jc)
        for name, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
        for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
            assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        episodes += int(m.episodes)
    assert episodes > 0
