"""The three train steps of the port over 8 CPU shards
(`parallel/train.py`: `build_train_step`, `build_packed_train_step`,
`build_fused_train_step(mesh=...)`) against the JAX package's over its
8-device CPU mesh, and the float-logit categorical they draw from.

The JAX outputs come from `data/parallel_reference.npz`
(`make_parallel_reference.py`, whose `slow` test in
`test_torch_parallel.py` recomputes them live): two chained steps from
`testing.dyadic_flax_params` (every f32 sum of the forward exact, so the
logits and the sampled actions agree) and optax's zero state. Tolerances,
with their reasons:
  * the states or carries after each step, byte for byte; Adam's count
    exactly;
  * the metrics to rtol 2e-3 (atol 1e-5), the bounds of the JAX
    package's kernel-against-XLA test (`test_torch_train.py` (f));
  * the params within 2·lr per step (Adam's first step is about
    ±lr·sign(g), so a tiny gradient whose sign differs moves by up to
    2·lr);
  * Adam's `mu` and `nu` per flax leaf, against the leaf's largest entry,
    which ties the whole gradient → clip → Adam chain to JAX's. The fused
    step (the gradient kernel's plain version against the JAX kernel in
    interpret mode, f32 sums rounded once) to `MOMENT_TOL`, as
    `test_torch_train.py` (f) holds it. The two autograd steps to the JAX
    package's bounds between its gradient kernel and its XLA pass: the f32
    heads 1e-3, the bf16 torso 0.05 (`AUTOGRAD_TOL`). Their torso
    cotangents are rounded to bf16 at every dense layer, and JAX sums the
    8 devices' bf16 partial products in bf16 (GSPMD's reduction of a bf16
    dot) where the port adds the shards' bf16-rounded sums in f32: torso
    `mu` 1.7e-2 of its largest entry at most on these cases, the heads
    7.5e-4 (step 2, taken from params up to 0.87·lr apart).
Over the mesh every step is the unsharded program on the whole batch: the
fused step over 8 shards equals the port's unsharded step on every
integer, and `build_train_step` and `build_packed_train_step` give the
same update, as the JAX package asserts (`tests/test_parallel.py:198`).

This file imports no JAX outside the categorical tests; its `gpu` tests
hold the sharded paths on the card (two shards of `cuda:0`) to their
one-shard and unsharded runs.
"""

import dataclasses
import functools

import make_multiroom_reference as mref
import make_parallel_reference as pref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.parallel import packed as pk
from minigrid_tpu_torch.parallel import train as TT
from minigrid_tpu_torch.parallel.sharding import gather_states, make_env_mesh, shard_states
from minigrid_tpu_torch.testing import dyadic_flax_params, moment_gaps
from minigrid_tpu_torch.utils.convert import carry_from_numpy, opt_state_to_numpy, state_from_numpy

CPU = torch.device("cpu")
MOMENT_TOL = 1e-5
AUTOGRAD_TOL = {"actor": 1e-3, "critic": 1e-3, "torso_0": 0.05, "torso_1": 0.05}
# The fused step over two shards of the card against the unsharded step:
# the shards' f32 kernel sums meet in another order before the torso's are
# rounded to bf16 once, so a torso entry may move by one bf16 ulp (2^-8 to
# 2^-7 of it: up to 2^-7 in mu, 2^-6 in nu); the f32 heads move with the
# clip's global norm, to phase 7's head bound (chip_smoke.py,
# P20_FUSED_MOMENT_TOL).
CUDA_FUSED_MOMENT_TOL = {"actor": 1e-4, "critic": 1e-4, "torso_0": 2**-6, "torso_1": 2**-6}
# jax 0.9's f32 gumbel `-log(-log(u))` over the 2^23 values of `bits >> 9`,
# against `prng.gumbel` (torch's `log`) on an x86 CPU: how many round
# apart. XLA:CPU's f32 `log` is not correctly rounded (it differs from a
# correctly rounded one on 1,187,990 of the 2^23 inner logs).
GUMBEL_ROUNDED_APART = 1_920_343


@functools.lru_cache(maxsize=None)
def _stored():
    return mref.load(pref.PATH)


def test_categorical_over_float_logits_matches_jax():
    jax = pytest.importorskip("jax")
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(512, 7)) * 2).astype(np.float32)
    logits[:, 3] = -np.inf  # a masked action is never drawn
    draw = jax.jit(jax.random.categorical)
    for seed in (0, 1, 2):
        want = np.asarray(draw(jax.random.PRNGKey(seed), logits))
        got = prng.categorical_logits(prng.key(seed, device=CPU), torch.from_numpy(logits))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        # A shard's lanes draw what they draw in the whole batch.
        part = prng.categorical_logits(prng.key(seed, device=CPU), torch.from_numpy(logits[96:160]), lane0=96)
        np.testing.assert_array_equal(part.numpy(), want[96:160])
    assert not (want == 3).any()


def test_jax_and_torch_f32_gumbels_round_apart_on_a_counted_set():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    def gumbel_of_m(m):
        floats = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        tiny = jnp.float32(np.finfo(np.float32).tiny)
        u = jnp.maximum(tiny, floats * (jnp.float32(1.0) - tiny) + tiny)
        return -jnp.log(-jnp.log(u))

    want = np.asarray(jax.jit(gumbel_of_m)(jnp.arange(2**23, dtype=jnp.uint32)))
    got = prng.gumbel(torch.arange(2**23, dtype=torch.int64) << 9).numpy()
    apart = want.view(np.int32) != got.view(np.int32)
    assert int(apart.sum()) == GUMBEL_ROUNDED_APART
    # Within what one ulp of the inner log and one of the outer make.
    assert (np.abs(want - got) / np.maximum(1, np.abs(want))).max() <= 2**-22


def test_per_env_gradient_pass_matches_jax():
    """`_trajectory_grads` (autograd through `ActorCritic`, time chunks of
    4) against the JAX package's on one random trajectory, under dyadic
    weights: the grads to `AUTOGRAD_TOL` of each leaf's largest entry, the
    metrics to rtol 2e-3 (atol 1e-5)."""
    jax = pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.parallel import train as JT

    t, b = 8, 32
    rng = np.random.default_rng(0)
    obs = np.stack([rng.integers(0, 11, (t, b, 7, 7)), rng.integers(0, 6, (t, b, 7, 7)),
                    rng.integers(0, 3, (t, b, 7, 7))], -1).astype(np.uint8)
    traj = (obs, rng.integers(0, 7, (t, b)).astype(np.int32), np.zeros((t, b), np.float32),
            rng.normal(size=(t, b)).astype(np.float32),
            (rng.random((t, b)) * (rng.random((t, b)) < 0.2)).astype(np.float32), rng.random((t, b)) < 0.1)
    params = dyadic_flax_params(pref.PARAMS_SEED)
    model = JT.make_model(minigrid_tpu.make("MiniGrid-Empty-8x8-v0"))
    want_g, want_m = jax.jit(lambda p, tr: JT._trajectory_grads(model, p, tr, TT.GAMMA, TT.VALUE_COEF,
                                                                   TT.ENTROPY_COEF))(params, traj)
    got_g, got_m = TT._trajectory_grads(ActorCritic.from_flax(params, device=CPU),
                                        tuple(torch.from_numpy(np.asarray(x)) for x in traj))
    for layer, leaves in want_g["params"].items():
        for leaf, w in leaves.items():
            w, g = np.asarray(w), got_g["params"][layer][leaf].numpy()
            assert g.shape == w.shape and g.dtype == np.float32, (layer, leaf)
            assert np.abs(w - g).max() / np.abs(w).max() <= AUTOGRAD_TOL[layer], (layer, leaf)
    assert set(got_m) == set(want_m)
    for k, w in want_m.items():
        np.testing.assert_allclose(float(got_m[k]), float(w), rtol=2e-3, atol=1e-5, err_msg=k)


def _port_train_calls(name, mesh):
    """The port's two chained steps of a `TRAIN_CASES` case over `mesh`
    from the stored inputs: per step (train state, gathered value,
    metrics)."""
    kind, env_id, mode, as_carry, _, t, _ = pref.TRAIN_CASES[name]
    env = make(env_id)
    ins = pref._stored_inputs(name, _stored())
    if as_carry:
        value = pk.shard_carry(carry_from_numpy(ins, device=CPU), mesh)
    else:
        value = shard_states(state_from_numpy(ins, device=CPU), mesh)
    if kind == "vmap":
        step = TT.build_train_step(env, t, mesh=mesh, mode=mode)
    elif kind == "packed":
        step = TT.build_packed_train_step(env, t, mesh=mesh, mode=mode, as_carry=as_carry)
    else:
        step = TT.build_fused_train_step(env, t, mode=mode, mesh=mesh)
    model = ActorCritic.from_flax(dyadic_flax_params(pref.PARAMS_SEED), device=CPU)
    ts = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    out = []
    for seed in pref.TRAIN_KEY_SEEDS:
        ts, value, metrics = step(ts, value, prng.key(seed, device=CPU))
        out.append((ts, pk.gather_carry(value) if as_carry else gather_states(value), metrics))
    return out


def _leaf_slices(model):
    """(name, slice) of each flax leaf in the flat vector."""
    tree, off, out = model.flax_params(), 0, []
    for n, k in TT._flax_names(tree):
        size = tree["params"][n][k].numel()
        out.append((f"{n}/{k}", slice(off, off + size)))
        off += size
    return out


def _assert_moments_close(ts, ref, tol, what=""):
    """`testing.moment_gaps(ts, ref)` within `tol`, a number or a bound
    per layer."""
    for leaf, gaps in moment_gaps(ts, ref).items():
        bound = tol[leaf.split("/")[0]] if isinstance(tol, dict) else tol
        assert max(gaps) <= bound, (what, leaf, gaps)


@pytest.mark.parametrize("name", sorted(pref.TRAIN_CASES))
def test_train_step_over_the_mesh_matches_jax(name):
    want = pref.case_arrays(name)
    kind, as_carry = pref.TRAIN_CASES[name][0], pref.TRAIN_CASES[name][3]
    calls = _port_train_calls(name, pref.port_mesh())
    for c, (ts, value, metrics) in enumerate(calls):
        prefix = f"{name}/call{c}"
        if as_carry:
            for k, v in mref.carry_arrays(value).items():
                np.testing.assert_array_equal(v, want[f"{prefix}/carry/{k}"], err_msg=f"{prefix} {k}")
        else:
            for k, v in pref._state_arrays("s", value).items():
                np.testing.assert_array_equal(v, want[f"{prefix}/states/{k[2:]}"], err_msg=f"{prefix} {k}")
        got_metrics = {k[len(prefix) + 9:]: v for k, v in pref.metric_arrays(prefix, metrics).items()}
        want_metrics = {k[len(prefix) + 9:]: v for k, v in want.items() if k.startswith(f"{prefix}/metrics/")}
        assert set(got_metrics) == set(want_metrics)
        for k, w in want_metrics.items():
            np.testing.assert_allclose(got_metrics[k], w, rtol=2e-3, atol=1e-5, err_msg=f"{prefix} {k}")
        flat = TT.flatten_params(ts.params.flax_params()).numpy()
        assert np.abs(flat - want[f"{prefix}/params"]).max() <= 2 * TT.LR * (c + 1) * (1 + 1e-3)
        adam = opt_state_to_numpy(ts.opt_state)
        assert int(adam["count"]) == int(want[f"{prefix}/count"]) == c + 1
        for moment in ("mu", "nu"):
            for leaf, sl in _leaf_slices(ts.params):
                w, g = want[f"{prefix}/{moment}"][sl], adam[moment][sl]
                rel = np.abs(w - g).max() / (np.abs(w).max() + 1e-30)
                tol = MOMENT_TOL if kind == "fused" else AUTOGRAD_TOL[leaf.split("/")[0]]
                assert rel <= tol, (prefix, moment, leaf, rel)
    assert float(np.asarray(want[f"{name}/call1/metrics/episodes"])) > 0


def test_fused_train_step_over_8_shards_equals_the_unsharded_step():
    name = "train_fused_empty5_regen"
    _, env_id, mode, _, _, t, _ = pref.TRAIN_CASES[name]
    mesh = pref.port_mesh()
    sharded = _port_train_calls(name, mesh)
    env = make(env_id)
    carry = carry_from_numpy(pref._stored_inputs(name, _stored()), device=CPU)
    model = ActorCritic.from_flax(dyadic_flax_params(pref.PARAMS_SEED), device=CPU)
    ts = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    step = TT.build_fused_train_step(env, t, mode=mode)
    for c, seed in enumerate(pref.TRAIN_KEY_SEEDS):
        ts, carry, metrics = step(ts, carry, prng.key(seed, device=CPU))
        s_ts, s_carry, s_metrics = sharded[c]
        for a, b in zip(carry, s_carry):
            assert torch.equal(a, b)
        for k in ("env_steps", "episodes"):
            assert torch.equal(metrics[k], s_metrics[k]), k
        for k, v in metrics.items():
            torch.testing.assert_close(s_metrics[k], v, rtol=1e-5, atol=1e-7)
        flat, s_flat = (TT.flatten_params(x.params.flax_params()) for x in (ts, s_ts))
        assert float((flat - s_flat).abs().max()) <= 2 * TT.LR * (c + 1) * (1 + 1e-3)
        _assert_moments_close(s_ts, ts, MOMENT_TOL, c)


def test_per_env_and_packed_train_steps_give_the_same_update():
    """The JAX package's `test_matches_vmap_train_step`, over 4 shards:
    the same trajectory, so the same loss, update and final states."""
    env = make("MiniGrid-Empty-8x8-v0")
    mesh = make_env_mesh(["cpu"] * 4)
    states = state_from_numpy(pref.port_states(env.env_id, 32, 9), device=CPU)
    model = ActorCritic.from_flax(dyadic_flax_params(2), device=CPU)
    ts0 = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    k = prng.key(8, device=CPU)
    out = [build(env, 8, mesh=mesh)(ts0, shard_states(states, mesh), k)
           for build in (TT.build_train_step, TT.build_packed_train_step)]
    (ts_v, st_v, m_v), (ts_p, st_p, m_p) = out
    for f in dataclasses.fields(states):
        assert torch.equal(getattr(gather_states(st_v), f.name), getattr(gather_states(st_p), f.name)), f.name
    for k_ in m_v:
        torch.testing.assert_close(m_p[k_], m_v[k_], rtol=1e-5, atol=1e-6)
    flat_v, flat_p = (TT.flatten_params(x.params.flax_params()) for x in (ts_v, ts_p))
    torch.testing.assert_close(flat_p, flat_v, rtol=1e-5, atol=1e-6)
    assert float(m_v["episodes"]) > 0
    assert torch.equal(TT.flatten_params(ts0.params.flax_params()),
                       TT.flatten_params(ActorCritic.from_flax(dyadic_flax_params(2), device=CPU).flax_params()))


def test_packed_train_step_refuses_what_the_packed_rollouts_do_not_run():
    env = make("MiniGrid-Empty-8x8-v0")
    with pytest.raises(ValueError, match="does not support"):
        TT.build_packed_train_step(env, 4, mode="bogus")


def test_train_state_lives_on_the_mesh_s_first_device():
    env = make("MiniGrid-Empty-5x5-v0")
    ts = TT.init_train_state(env, mesh=make_env_mesh(["cpu"] * 2))
    assert next(ts.params.parameters()).device == CPU and ts.opt_state.mu.device == CPU
    with pytest.raises(ValueError, match="first device"):
        TT.init_train_state(env, device="meta", mesh=make_env_mesh(["cpu"] * 2))


# ----------------------------------------------------------------- the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cuda_carry(env_id, mode, b, seed):
    return carry_from_numpy(pref.port_carry_arrays(env_id, mode, b, seed), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,mode", [("MiniGrid-Empty-8x8-v0", "regen"), ("MiniGrid-DoorKey-5x5-v0", "regen")])
def test_cuda_sharded_rollouts_replay_each_shard(env_id, mode):
    """Phases 20a/20b at small B: two shards of the card against the
    one-device kernels under `fold_in(key, i)`, byte for byte."""
    dev = _cuda()
    env = make(env_id)
    mesh = make_env_mesh([dev, dev])
    carry = _cuda_carry(env_id, mode, 256, 1)
    k = prng.key(2, device=dev)
    params = dyadic_flax_params(1)
    from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_rollout

    for sharded, one in (
        (pk.build_sharded_rollout(env, 16, mesh, mode=mode, as_carry=True),
         tfr.build_fused_rollout(env, 16, mode=mode, as_carry=True)),
        (pk.build_sharded_policy_eval(env, params, 16, mesh, mode=mode, as_carry=True),
         build_policy_eval_rollout(env, params, 16, mode=mode, as_carry=True)),
    ):
        shards = pk.shard_carry(carry, mesh)
        got, total = sharded(k, shards)
        eps = 0
        for i, shard in enumerate(shards):
            c, m = one(prng.fold_in(k, i), shard)
            assert all(torch.equal(a, b) for a, b in zip(c, got[i]))
            eps += int(m.episodes)
        assert int(total.episodes) == eps and int(total.total_steps) == 256 * 16


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,mode", [("MiniGrid-Empty-8x8-v0", "regen"), ("MiniGrid-KeyCorridorS3R1-v0", "regen")])
def test_cuda_sharded_fused_train_step_equals_the_unsharded_step(env_id, mode):
    """Phase 20c at small B: two shards of the card against the unsharded
    step, two chained steps: the carry after step 1 byte for byte (step 2
    acts with params a float sum order apart), Adam's moments per leaf to
    `CUDA_FUSED_MOMENT_TOL`, the params within 2·lr a step."""
    dev = _cuda()
    env = make(env_id)
    mesh = make_env_mesh([dev, dev])
    carry = _cuda_carry(env_id, mode, 256, 3)
    model = ActorCritic.from_flax(dyadic_flax_params(4), device=dev)
    ts = ts_s = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    carries = pk.shard_carry(carry, mesh)
    one = TT.build_fused_train_step(env, 16, mode=mode, regen_chunk=8)
    two = TT.build_fused_train_step(env, 16, mode=mode, regen_chunk=8, mesh=mesh)
    for n, seed in enumerate((5, 6), start=1):
        ts, carry, m = one(ts, carry, prng.key(seed, device=dev))
        ts_s, carries, m_s = two(ts_s, carries, prng.key(seed, device=dev))
        if n == 1:
            assert all(torch.equal(a, b) for a, b in zip(carry, pk.gather_carry(carries)))
            assert torch.equal(m["episodes"], m_s["episodes"])
        assert torch.equal(m["env_steps"], m_s["env_steps"])
        flat, flat_s = (TT.flatten_params(x.params.flax_params()) for x in (ts, ts_s))
        assert float((flat - flat_s).abs().max()) <= 2 * TT.LR * n * (1 + 1e-3)
        _assert_moments_close(ts_s, ts, CUDA_FUSED_MOMENT_TOL, n)


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,mode", [("MiniGrid-Empty-8x8-v0", "cached"), ("MiniGrid-DoorKey-5x5-v0", "regen")])
def test_cuda_train_steps_over_two_shards_equal_one_shard(env_id, mode):
    """Phase 20d at small B: `build_train_step` and
    `build_packed_train_step` over two shards of the card against one
    shard, equal on every integer, Adam's moments per leaf to
    `AUTOGRAD_TOL`."""
    dev = _cuda()
    env = make(env_id)
    states = state_from_numpy(pref.port_states(env_id, 64, 7), device=dev)
    model = ActorCritic.from_flax(dyadic_flax_params(2), device=dev)
    ts0 = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    k = prng.key(8, device=dev)
    for build in (TT.build_train_step, TT.build_packed_train_step):
        outs = []
        for n in (1, 2):
            mesh = make_env_mesh([dev] * n)
            ts, st, m = build(env, 8, mesh=mesh, mode=mode)(ts0, shard_states(states, mesh), k)
            outs.append((gather_states(st), m, ts))
        (a, ma, ta), (b, mb, tb) = outs
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), (build.__name__, f.name)
        assert torch.equal(ma["episodes"], mb["episodes"])
        _assert_moments_close(tb, ta, AUTOGRAD_TOL, build.__name__)
