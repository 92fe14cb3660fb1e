"""The fused train step of the port against the JAX package's
`parallel/train.py`, `ops/policy_rollout.py` (collect mode) and
`ops/grad_kernel.py`, on the same numpy inputs, at B = 128, T = 8 on
Empty-5x5 (regen, static layout).

Tolerances, with their reasons:
  * (a) The collect-mode twin against `build_fused_train_rollout(backend=
    "xla", raw_obs=True)` under `dyadic_flax_params` (every f32 sum of the
    forward exact in any order): the carry, obs words, actions, done and
    the episode and checksum totals byte-exact; value and reward bit for
    bit; logp to rtol 1e-6, because it takes one `log` and XLA:CPU's `log`
    and `exp` are not the C library's.
  * (b) `_trajectory_returns`: rtol 1e-6 (XLA may fuse the multiply-adds).
  * (c) `plain_grad_pass` (the port's `_trajectory_grads_kernel` on the
    CPU) against the JAX kernel in interpret mode on one collected
    trajectory under flax-initialised weights, with the JAX package's
    `TestGradKernel` bounds: the f32 heads (actor, critic) to 1e-4 of their
    largest entry, the bf16 torso to 0.05, the loss sums finite and to
    rtol 1e-4. The torso cotangents are rounded to bf16, and the two sum
    in different orders.
  * (d) `plain_grad_pass` against torch autograd of the same loss (the
    port's `_trajectory_grads_packed`), and that pass against JAX's
    `_trajectory_grads_packed`, with the bounds of the JAX package's
    kernel-against-XLA test: metrics rtol 2e-3, heads 1e-3 of their
    largest entry, torso 0.05. The autograd pass accumulates the bf16
    torso cotangents in bf16 across its time chunks, as JAX's does.
  * (e) clip + Adam against optax on the same numpy grads, three steps of
    which one is clipped: rtol 1e-6, with an absolute floor of 1e-6 of the
    largest entry. XLA:CPU rounds the moment update `0.1·g + 0.9·mu`
    differently from two rounded products and a rounded sum (a one-ulp
    difference in `mu`), which is large relative to the entries where the
    two terms cancel; the norm's sum order and `pow` differ too. The
    optimizer state converts to and from optax's exactly.
  * (f) Two chained `build_fused_train_step` calls against JAX's
    (`backend="xla"`, `grad_backend="kernel"`), from the same dyadic params
    and a converted optimizer state: metrics rtol 2e-3, carries
    byte-exact, params within 2·lr per step (Adam's first step is about
    ±lr·sign(g), so a tiny grad whose sign differs moves by up to 2·lr).
    The params bound passes for any gradient of Adam's scale, so the
    optimizer state is compared too: after step 1 `mu` is `0.1·clip(g)`,
    so `mu` and `nu` against optax's tie the whole gradient → clip → Adam
    chain to JAX's. Each flax leaf of both is held to 1e-5 of its largest
    entry (on this CPU the readings are at most 1.4e-6, in the actor
    head; the bf16-rounded torso cotangents agree exactly at step 1).
    The step leaves the state passed in as it was.

Each JAX reference runs through one cached `jax.jit`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

import minigrid_tpu
from minigrid_tpu.core.state import EnvState as JaxEnvState
from minigrid_tpu.ops import fused_rollout as jfr
from minigrid_tpu.ops import policy_rollout as jpr
from minigrid_tpu.parallel import train as JT
from minigrid_tpu.parallel.sharding import make_env_mesh
from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.parallel import train as TT
from minigrid_tpu_torch.testing import dyadic_flax_params
from minigrid_tpu_torch.utils.convert import (
    carry_to_numpy,
    grads_to_flax_numpy,
    opt_state_from_optax,
    opt_state_to_numpy,
    state_to_numpy,
)

ENV_ID = "MiniGrid-Empty-5x5-v0"
B = 128
T = 8
VIEW = 7
NUM_ACTIONS = 7
GAMMA, VALUE_COEF, ENTROPY_COEF = TT.GAMMA, TT.VALUE_COEF, TT.ENTROPY_COEF
LR = TT.LR
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_states(seed):
    """Empty-5x5 states with step counts spread over the episode, so that
    truncation resets fire within T steps."""
    env = make(ENV_ID)
    states, _ = env.reset_batch(prng.key(seed, device=CPU), B)
    sc = np.random.default_rng(seed).integers(0, env.config.max_steps, size=B).astype(np.int32)
    return states.replace(step_count=torch.from_numpy(sc))


@functools.lru_cache(maxsize=None)
def _jax_train_state():
    """`init_train_state` without its mesh, in one jit."""
    env = minigrid_tpu.make(ENV_ID)

    @jax.jit
    def init(key):
        params = JT.make_model(env).init(key, jnp.zeros((1, VIEW, VIEW, 3), jnp.uint8))
        return JT.TrainState(params, JT.make_optimizer().init(params))

    return _np_tree(init(jax.random.PRNGKey(0)))


def _ravel(tree) -> np.ndarray:
    """`ravel_pytree` of a numpy tree, without a JAX op."""
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


@functools.lru_cache(maxsize=None)
def _jax_collect_and_grads():
    """One jit: the collecting rollout and, on its trajectory, the returns
    and both JAX gradient passes. Run under dyadic params (for (a)) and
    under flax-initialised params (for (c), (d))."""
    env = minigrid_tpu.make(ENV_ID)

    @jax.jit
    def refs(states, key, params):
        roll = jpr.build_fused_train_rollout(env, T, mode="regen", backend="xla", raw_obs=True)
        carry0 = jfr.packed_init(env, states, "regen")
        carry, traj, metrics = roll(params, key, carry0)
        args = (VIEW, NUM_ACTIONS, GAMMA, VALUE_COEF, ENTROPY_COEF)
        g_k, m_k = JT._trajectory_grads_kernel(params, traj, *args, interpret=True)
        g_x, m_x = JT._trajectory_grads_packed(params, traj, *args)
        images = jpr.obs_words_to_images(traj[0], VIEW)
        return dict(carry=carry, traj=traj, metrics=metrics, g_k=g_k, m_k=m_k, g_x=g_x, m_x=m_x, images=images)

    states = {f: jnp.asarray(a) for f, a in state_to_numpy(_port_states(3)).items()}
    key = jax.random.PRNGKey(4)
    return {
        "dyadic": _np_tree(refs(JaxEnvState(**states), key, dyadic_flax_params(2))),
        "flax": _np_tree(refs(JaxEnvState(**states), key, _jax_train_state().params)),
    }


def _port_traj(jtraj):
    """A JAX trajectory as the port's tensors (done as int32, as the spill
    holds it)."""
    out = [torch.from_numpy(np.array(x)) for x in jtraj]
    out[5] = out[5].to(torch.int32)
    return tuple(out)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def test_collect_twin_matches_jax_xla_rollout():
    ref = _jax_collect_and_grads()["dyadic"]
    env = make(ENV_ID)
    carry0 = tfr.packed_init(env, _port_states(3), "regen")
    roll = tpr.build_fused_train_rollout(env, T, mode="regen")
    weights = tpr.train_weights_from_params(dyadic_flax_params(2), VIEW, device=CPU)
    carry, traj, metrics = roll(weights, prng.key(4, device=CPU), carry0)

    for name, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, getattr(ref["carry"], name), err_msg=f"carry {name}")
    obs, actions, logp, value, reward, done = traj
    j_obs, j_actions, j_logp, j_value, j_reward, j_done = ref["traj"]
    assert obs.dtype == actions.dtype == done.dtype == torch.int32
    assert tuple(obs.shape) == (T, VIEW * VIEW, B) and tuple(done.shape) == (T, B)
    np.testing.assert_array_equal(obs.numpy(), j_obs)
    np.testing.assert_array_equal(actions.numpy(), j_actions)
    np.testing.assert_array_equal(done.numpy().astype(bool), j_done)
    np.testing.assert_array_equal(value.numpy().view(np.int32), j_value.view(np.int32))
    np.testing.assert_array_equal(reward.numpy().view(np.int32), j_reward.view(np.int32))
    np.testing.assert_allclose(logp.numpy(), j_logp, rtol=1e-6, atol=0)
    for name in ("episodes", "total_steps", "obs_checksum"):
        assert int(getattr(metrics, name)) == int(getattr(ref["metrics"], name)), name
    assert int(metrics.episodes) > 0 and len(np.unique(actions.numpy())) == NUM_ACTIONS
    # Every field is a view of the one spill.
    base = obs.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in traj)
    np.testing.assert_array_equal(tpr.obs_words_to_images(obs, VIEW).numpy(), ref["images"])


def test_trajectory_returns_match_jax():
    rng = np.random.default_rng(0)
    reward = (rng.random((16, B)) * (rng.random((16, B)) < 0.2)).astype(np.float32)
    done = rng.random((16, B)) < 0.1
    want = np.asarray(jax.jit(JT._trajectory_returns, static_argnums=2)(reward, done, GAMMA))
    got = TT._trajectory_returns(torch.from_numpy(reward), torch.from_numpy(done.astype(np.int32)), GAMMA)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _port_grads(kind, params, jtraj):
    fn = TT._trajectory_grads_kernel if kind == "kernel" else TT._trajectory_grads_packed
    g, m = fn(TT._train_weights(params, VIEW, CPU), _port_traj(jtraj), VIEW, NUM_ACTIONS)
    return grads_to_flax_numpy(g)["params"], {k: float(v) for k, v in m.items()}


def _check_grads(got, want, head_tol, torso_tol):
    for layer in want:
        for leaf, w in want[layer].items():
            g = got[layer][leaf]
            assert g.shape == w.shape and g.dtype == np.float32, (layer, leaf)
            tol = head_tol if layer in ("actor", "critic") else torso_tol
            assert _rel(w, g) < tol, (layer, leaf, _rel(w, g))


def test_plain_grad_pass_matches_jax_kernel():
    ref = _jax_collect_and_grads()["flax"]
    g, m = _port_grads("kernel", ActorCritic.from_flax(_jax_train_state().params, device=CPU), ref["traj"])
    _check_grads(g, ref["g_k"]["params"], 1e-4, 0.05)
    for name in ("pg_loss", "v_loss", "entropy"):
        assert np.isfinite(m[name])
        np.testing.assert_allclose(m[name], float(ref["m_k"][name]), rtol=1e-4)


def test_plain_grad_pass_matches_autograd_and_jax_packed_pass():
    ref = _jax_collect_and_grads()["flax"]
    params = _jax_train_state().params
    g_plain, m_plain = _port_grads("kernel", params, ref["traj"])
    g_auto, m_auto = _port_grads("packed", params, ref["traj"])
    jax_packed = (ref["g_x"]["params"], {k: float(v) for k, v in ref["m_x"].items()})
    for (g_ref, m_ref), (g, m) in (((g_auto, m_auto), (g_plain, m_plain)), (jax_packed, (g_auto, m_auto))):
        _check_grads(g, g_ref, 1e-3, 0.05)
        for name, want in m_ref.items():
            np.testing.assert_allclose(m[name], want, rtol=2e-3, atol=1e-5, err_msg=name)
    assert m_plain["episodes"] > 0


@functools.lru_cache(maxsize=None)
def _optax_three_steps():
    rng = np.random.default_rng(1)
    params = _jax_train_state().params
    n = _ravel(params).shape[0]
    # Global norms 0.1, 2.0 (clipped to 0.5) and 0.3.
    grads = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    grads = [g * np.float32(s / np.linalg.norm(g)) for g, s in zip(grads, (0.1, 2.0, 0.3))]
    opt = JT.make_optimizer()

    @jax.jit
    def run(params, grads):
        flat, unravel = ravel_pytree(params)
        state = opt.init(params)
        outs = []
        for g in grads:
            updates, state = opt.update(unravel(g), state, params)
            outs.append((ravel_pytree(updates)[0], state))
        return flat, outs

    flat, outs = _np_tree(run(params, grads))
    return grads, outs, flat


def test_optimizer_matches_optax():
    grads, outs, _ = _optax_three_steps()
    opt = TT.make_optimizer()
    state = opt.init(torch.zeros(grads[0].shape[0]))
    for g, (want_updates, want_state) in zip(grads, outs):
        updates, state = opt.update(torch.from_numpy(g), state)
        got = opt_state_to_numpy(state)
        adam = want_state[1][0]
        assert got["count"].dtype == np.int32 and int(got["count"]) == int(adam.count)
        for name, x, want in (("updates", updates.numpy(), want_updates), ("mu", got["mu"], adam.mu),
                              ("nu", got["nu"], adam.nu)):
            np.testing.assert_allclose(x, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_opt_state_and_params_round_trip():
    _, outs, jax_flat = _optax_three_steps()
    jax_state = outs[-1][1]
    port = opt_state_from_optax(jax_state, device=CPU)
    back = opt_state_to_numpy(port)
    adam = jax_state[1][0]
    np.testing.assert_array_equal(back["count"], adam.count)
    np.testing.assert_array_equal(back["mu"], adam.mu)
    np.testing.assert_array_equal(back["nu"], adam.nu)
    params = _jax_train_state().params
    flat = TT.flatten_params(ActorCritic.from_flax(params, device=CPU).flax_params())
    np.testing.assert_array_equal(flat.numpy(), jax_flat)
    assert flat.shape == (318_984,)


@functools.lru_cache(maxsize=None)
def _jax_two_train_steps():
    env = minigrid_tpu.make(ENV_ID)
    mesh = make_env_mesh(jax.devices()[:1])
    step = JT.build_fused_train_step(env, mesh, T, mode="regen", backend="xla", grad_backend="kernel")
    params = jax.tree.map(jnp.asarray, dyadic_flax_params(2))
    ts = JT.TrainState(params, jax.jit(JT.make_optimizer().init)(params))
    states = JaxEnvState(**{f: jnp.asarray(a) for f, a in state_to_numpy(_port_states(5)).items()})
    carry = jax.jit(lambda s: jfr.packed_init(env, s, "regen"))(states)
    out = []
    for seed in (6, 7):
        ts, carry, metrics = step(ts, carry, jax.random.PRNGKey(seed))
        out.append(_np_tree((ts, carry, metrics)))
    return out


def _leaf_names(tree):
    return [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _split_leaves(flat, tree):
    """A flat vector in `ravel_pytree`'s order, cut into the tree's leaves."""
    sizes = np.cumsum([np.size(x) for x in jax.tree.leaves(tree)])[:-1]
    return np.split(flat, sizes)


def test_fused_train_step_matches_jax():
    want = _jax_two_train_steps()
    env = make(ENV_ID)
    model = ActorCritic.from_flax(dyadic_flax_params(2), device=CPU)
    ts = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    carry = tfr.packed_init(env, _port_states(5), "regen")
    step = TT.build_fused_train_step(env, T, mode="regen")
    p0 = TT.flatten_params(model.flax_params())
    for n, (seed, (j_ts, j_carry, j_metrics)) in enumerate(zip((6, 7), want), start=1):
        ts_in, p_in, s_in = ts, TT.flatten_params(ts.params.flax_params()), opt_state_to_numpy(ts.opt_state)
        ts, carry, metrics = step(ts, carry, prng.key(seed, device=CPU))
        assert torch.equal(TT.flatten_params(ts_in.params.flax_params()), p_in)  # left as it was
        for name, x in opt_state_to_numpy(ts_in.opt_state).items():
            np.testing.assert_array_equal(x, s_in[name])
        for name, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, getattr(j_carry, name), err_msg=f"step {n} carry {name}")
        assert set(metrics) == set(j_metrics)
        for name, got in metrics.items():
            np.testing.assert_allclose(float(got), float(j_metrics[name]), rtol=2e-3, atol=1e-5, err_msg=name)
        flat = TT.flatten_params(ts.params.flax_params())
        j_flat = _ravel(j_ts.params)
        assert np.abs(flat.numpy() - j_flat).max() <= 2 * LR * n * (1 + 1e-3)
        assert int(ts.opt_state.count) == int(j_ts.opt_state[1][0].count) == n
        got, adam = opt_state_to_numpy(ts.opt_state), j_ts.opt_state[1][0]
        for name in ("mu", "nu"):
            for leaf, g, w in zip(_leaf_names(j_ts.params), _split_leaves(got[name], j_ts.params),
                                  _split_leaves(np.asarray(getattr(adam, name)), j_ts.params)):
                assert _rel(w, g) <= 1e-5, (n, name, leaf, _rel(w, g))
    assert int(metrics["env_steps"]) == B * T
    assert float((flat - p0).abs().max()) > LR / 2  # the params moved
