"""Policy evaluation with the pickup-target hook and training on random
layouts, in the port against the JAX package; on a card, the kernels
against their plain versions.

Against the JAX package (its outputs held in
`data/regen_train_reference.npz`, written by
`make_regen_train_reference.py`, whose references compile the KeyCorridor
and MultiRoom generators inside chunked regen; each `slow` test recomputes
its case live and compares), from the port's own carry, under
`testing.dyadic_flax_params` (every f32 sum of the actor exact in any
order):
  * KeyCorridorS3R1 policy evaluation, B = 128, two calls of T = 16, in
    cached mode and in regen mode (chunk 8, `max_steps` cut to 5), on
    planted pickup targets: carries, `episodes`, `obs_checksum` and
    `reset_overlaps` byte-exact, `total_reward` to rtol 1e-6 (the
    batch-sum order, ROADMAP.md §C);
  * the collecting rollout under chunked regen (chunk 8, `max_steps` 5)
    at KeyCorridorS3R1 (B = 128) and MultiRoom-N2-S4 (B = 64), two calls
    of T = 16, against `build_fused_train_rollout(backend="xla",
    raw_obs=True)`: the carries, the integer metrics and the merged
    trajectory's obs words, actions and done byte-exact, value bit for
    bit, logp to rtol 1e-6 (one `log`, whose XLA:CPU version is not the C
    library's; `test_torch_train.py` (a)) and reward to rtol 1e-6 (XLA:CPU
    folds `0.9 / max_steps` into one constant, so a success's reward can
    differ in its last bit, as `total_reward` does; ROADMAP.md §C), with
    deferred resets (`reset_overlaps > 0`, re-entry passes);
  * DynamicObstacles-5x5 and MemoryS7 policy evaluation in regen mode
    (chunk 8, `max_steps` 5; the pre-hook and the remaps, DynamicObstacles
    with 3 actions), as KeyCorridor's;
  * two chained train steps on KeyCorridorS3R1 regen, on DoorKey-5x5
    regen (no packed generator: the refresh packs the batched
    `generate`) and on DynamicObstacles-5x5 regen (3 actions: the head's
    actor rows, the pre-hook), `max_steps` 5, against
    `build_fused_train_step(backend="xla", grad_backend="kernel")` (the
    gradient kernel in interpret mode), with `test_torch_train.py` (f)'s
    bounds: carries byte-exact, metrics rtol 2e-3, params within 2·lr per
    step, Adam's `mu` and `nu` per flax leaf within 1e-5 of its largest
    entry.
Without a file: `policy_rollout_supported` against the JAX package's on
every ported id, both modes, with and without `collect`; `_merge_spill`
against the JAX package's on numpy inputs, through one `jax.jit` per
shape.

JAX is imported only by the tests that compare with it live, so the `gpu`
tests also run on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/port/test_torch_train_regen.py -q
"""

import dataclasses
import functools

import make_regen_train_reference as ref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import chunked_regen as tcr
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.ops.packing import R_AUX
from minigrid_tpu_torch.parallel import train as TT
from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case
from minigrid_tpu_torch.utils.convert import carry_to_numpy, opt_state_to_numpy

CPU = torch.device("cpu")
MR = ref.mref
LR = TT.LR


def _file_in(name, carry):
    """Case `name`'s arrays, after checking that its input carry is `carry`."""
    arrays = ref.case_arrays(name)
    for field, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, arrays[f"in/{field}"], err_msg=f"input carry {field}")
    return arrays


def _assert_call(i, carry, metrics, arrays):
    for field, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, arrays[f"call{i}/carry/{field}"], err_msg=f"call {i} {field}")
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        assert getattr(metrics, name).dtype == torch.int32, name
        assert int(getattr(metrics, name)) == int(arrays[f"call{i}/metrics/{name}"]), (i, name)
    np.testing.assert_allclose(float(metrics.total_reward), float(arrays[f"call{i}/metrics/total_reward"]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# What the policy rollouts take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("mode", ["cached", "regen"])
@pytest.mark.parametrize("env_id", env_list)
def test_policy_rollout_supported_matches_jax(env_id, mode, collect):
    pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.ops import policy_rollout as jpr

    want = jpr.policy_rollout_supported(minigrid_tpu.make(env_id), mode, collect=collect)
    assert tpr.policy_rollout_supported(make(env_id), mode, collect=collect) == want


def test_unported_paths_still_refused():
    """A transition without packed hooks and a grid the shared-memory
    budget refuse; a random layout without a packed generator (Empty-8x8
    with a random start) is taken as the JAX package takes it, through its
    batched `generate`."""
    pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.ops import policy_rollout as jpr

    kc = make(ref.KC)
    memory = dataclasses.replace(kc, transition="no_such_transition")
    empty = make("MiniGrid-Empty-8x8-v0")
    random_start = dataclasses.replace(empty, config=dataclasses.replace(empty.config, agent_start_pos=None))
    big = dataclasses.replace(empty, config=dataclasses.replace(empty.config, width=40, height=40))
    assert not any(tpr.policy_rollout_supported(e, "regen", c) for e in (memory, big) for c in (False, True))
    jempty = minigrid_tpu.make("MiniGrid-Empty-8x8-v0")
    jrandom = dataclasses.replace(jempty, config=dataclasses.replace(jempty.config, agent_start_pos=None))
    for c in (False, True):
        assert tpr.policy_rollout_supported(random_start, "regen", c) == jpr.policy_rollout_supported(
            jrandom, "regen", collect=c) is True
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpr.build_fused_train_rollout(memory, 8, mode="cached")
    tpr.build_fused_train_rollout(random_start, 8, mode="regen")
    with pytest.raises(ValueError, match="does not support"):
        TT.build_fused_train_step(big, 8, mode="cached")


# ---------------------------------------------------------------------------
# The spill merge
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_merge(first_pass):
    import jax
    from minigrid_tpu.ops import chunked_regen as jcr

    def merge(slabs, spills, c0, c1):
        return tuple(jcr._merge_spill(s, x, c0, c1, first_pass=first_pass) for s, x in zip(slabs, spills))

    return jax.jit(merge)


def _merge_inputs(tc, first_pass, b=64, seed=0):
    """Two leaves, `(tc, 3, B)` int32 and `(tc, B)` f32, and cursors with
    lanes at 0, mid-chunk and `tc`."""
    rng = np.random.default_rng(seed + tc)
    leaves = lambda: (rng.integers(-9, 9, (tc, 3, b)).astype(np.int32),  # noqa: E731
                      rng.standard_normal((tc, b)).astype(np.float32))
    slabs, spills = leaves(), leaves()
    c0 = np.zeros(b, np.int64) if first_pass else rng.integers(0, tc + 1, b)
    c0[1:4] = (0, tc // 2, tc) if not first_pass else 0
    c1 = c0 + rng.integers(0, tc + 1, b) % (tc - c0 + 1)
    c1[4:7] = (c0[4], tc, c0[6] + (tc - c0[6]) // 2)
    return slabs, spills, c0[None].astype(np.int32), c1[None].astype(np.int32)


@pytest.mark.parametrize("first_pass", [False, True])
@pytest.mark.parametrize("tc", [1, 5, 8, 32])
def test_merge_spill_matches_jax(tc, first_pass):
    pytest.importorskip("jax")
    slabs, spills, c0, c1 = _merge_inputs(tc, first_pass)
    want = _jax_merge(first_pass)(slabs, spills, c0, c1)
    t = torch.from_numpy
    for s, x, w in zip(slabs, spills, want):
        got = tcr._merge_spill(t(s), t(x), t(c0), t(c1), first_pass=first_pass)
        assert got.dtype == t(s).dtype
        np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(w).view(np.int32))
    assert (c1 > c0).any() and (c0 == tc).any() == (not first_pass)


# ---------------------------------------------------------------------------
# Against the JAX package's outputs in the file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cached", "regen"])
def test_keycorridor_policy_eval_matches_jax(mode):
    _policy_eval_matches(f"kc_eval_{mode}")


@pytest.mark.parametrize("name", ["do_eval_regen", "mem_eval_regen"])
def test_remapped_family_policy_eval_matches_jax(name):
    """DynamicObstacles-5x5 (the pre-hook, its remap, 3 actions) and
    MemoryS7 (its remap) in regen mode."""
    _policy_eval_matches(name)


def _policy_eval_matches(name):
    _, _, mode, _, t, _, chunk, _, key_seed, _ = ref.CASES[name]
    carry = ref.port_carry(name)
    arrays = _file_in(name, carry)
    step = tpr.build_policy_eval_rollout(ref.port_env(name), ref.params(name, ref.PARAMS_SEED), t, mode=mode,
                                         as_carry=True, regen_chunk=chunk)
    metrics = []
    for i in range(2):
        carry, m = step(prng.key(key_seed, device=CPU), carry)
        _assert_call(i, carry, m, arrays)
        metrics.append(m)
    if name.startswith("kc"):
        assert float(metrics[0].total_reward) > 0  # the hook's successes
    if mode == "regen":
        assert sum(int(m.reset_overlaps) for m in metrics) > 0


def _assert_traj(i, traj, arrays):
    obs_w, actions, logp, value, reward, done = traj
    for k, got in ((0, obs_w), (1, actions)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), arrays[f"call{i}/traj/{k}"], err_msg=f"call {i} traj {k}")
    np.testing.assert_array_equal(value.numpy().view(np.int32), arrays[f"call{i}/traj/3"].view(np.int32),
                                  err_msg=f"call {i} value")
    for k, got in ((2, logp), (4, reward)):
        np.testing.assert_allclose(got.numpy(), arrays[f"call{i}/traj/{k}"], rtol=1e-6, atol=0,
                                   err_msg=f"call {i} traj {k}")
    assert set(np.unique(done.numpy())) <= {0, 1}
    np.testing.assert_array_equal(done.numpy().astype(bool), arrays[f"call{i}/traj/5"])


@pytest.mark.parametrize("name", ["kc_collect_regen", "mr_collect_regen"])
def test_collecting_regen_rollout_matches_jax(name):
    _, _, mode, b, t, _, chunk, _, key_seed, _ = ref.CASES[name]
    carry = ref.port_carry(name)
    arrays = _file_in(name, carry)
    roll = tpr.build_fused_train_rollout(ref.port_env(name), t, mode=mode, regen_chunk=chunk)
    w = tpr.train_weights_from_params(dyadic_flax_params(ref.PARAMS_SEED), 7, device=CPU)
    passes = tcr.reentry_passes
    overlaps = 0
    for i in range(2):
        carry, traj, m = roll(w, prng.key(key_seed, device=CPU), carry)
        _assert_call(i, carry, m, arrays)
        _assert_traj(i, traj, arrays)
        assert all(x.shape[:1] == (t,) and x.shape[-1] == b for x in traj)
        overlaps += int(m.reset_overlaps)
    assert overlaps > 0 and tcr.reentry_passes > passes


def _rel(want, got):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_regen_train_steps_match_jax():
    _train_steps_match("kc_train_regen")


def test_doorkey_regen_train_steps_match_jax():
    """DoorKey-5x5, whose chunked regen refreshes through the batched
    `generate`: the plain train step against the JAX package's, with the
    bounds of KeyCorridor's but for Adam's torso moments, held to 5e-5 of
    a leaf's largest entry. Both passes round the torso cotangents to bf16
    and sum them in different orders, so one rounding can flip, and here
    one does: after step 2 the torso moments differ by up to 1.17e-5
    (torso_1/kernel's `mu`, on one thread; 2.8e-6 on eight), while every
    head leaf stays within 2.6e-6."""
    _train_steps_match("dk_train_regen", torso_tol=5e-5)


def test_dynamicobstacles_regen_train_steps_match_jax():
    """DynamicObstacles-5x5 (the pre-hook, the remap, 3 actions, the
    batched `generate` in the refresh): the plain train step against the
    JAX package's, with DoorKey's bounds."""
    _train_steps_match("do_train_regen", torso_tol=5e-5)


def _train_steps_match(name, torso_tol=1e-5):
    _, _, mode, b, t, _, chunk, _, _, _ = ref.CASES[name]
    carry = ref.port_carry(name)
    arrays = _file_in(name, carry)
    params = ref.params(name, ref.TRAIN_PARAMS_SEED)
    sizes = ref.leaf_sizes(params["params"])
    model = ActorCritic.from_flax(params, device=CPU)
    ts = TT.TrainState(model, TT.make_optimizer().init(TT.flatten_params(model.flax_params())))
    step = TT.build_fused_train_step(ref.port_env(name), t, mode=mode, regen_chunk=chunk)
    p0 = TT.flatten_params(model.flax_params())
    for n, seed in enumerate(ref.TRAIN_KEYS, start=1):
        ts, carry, metrics = step(ts, carry, prng.key(seed, device=CPU))
        pre = f"step{n - 1}/"
        for field, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, arrays[pre + f"carry/{field}"], err_msg=f"step {n} carry {field}")
        assert set(metrics) == set(ref.TRAIN_METRICS)
        for k, got in metrics.items():
            np.testing.assert_allclose(float(got), float(arrays[pre + f"metrics/{k}"]), rtol=2e-3, atol=1e-5,
                                       err_msg=k)
        flat = TT.flatten_params(ts.params.flax_params())
        assert np.abs(flat.numpy() - arrays[pre + "params"]).max() <= 2 * LR * n * (1 + 1e-3)
        got = opt_state_to_numpy(ts.opt_state)
        assert int(ts.opt_state.count) == int(arrays[pre + "count"]) == n
        cuts = np.cumsum(sizes)[:-1]
        torso = [leaf.startswith("torso") for leaf in ref.leaf_names(params["params"])]
        for moment in ("mu", "nu"):
            for is_torso, g, w in zip(torso, np.split(got[moment], cuts), np.split(arrays[pre + moment], cuts)):
                assert _rel(w, g) <= (torso_tol if is_torso else 1e-5), (n, moment, _rel(w, g))
    assert int(metrics["env_steps"]) == b * t
    assert float((flat - p0).abs().max()) > LR / 2  # the params moved


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(ref.CASES))
def test_reference_file_matches_jax(name):
    pytest.importorskip("jax")
    want = {k[len(name) + 1:]: v for k, v in ref.jax_case(name).items()}
    MR.assert_same_arrays(ref.case_arrays(name), want,
                          rtol_names=("total_reward", "traj/2", "traj/4", "loss", "entropy", "params", "mu", "nu"))


# ---------------------------------------------------------------------------
# On a card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the policy twin's f32 GEMMs in full f32
    return torch.device("cuda")


def hooked_case(cfg, b, seed, hook: bool):
    """Random packed states (`testing.random_packed_case`) whose aux rows
    name a pickup target (a key, ball or box of some colour) when `hook`,
    so the pickup-target hook's successes fire."""
    case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    if hook:
        rng = np.random.default_rng(seed + 1)
        for regs in (case["regs"], case["tmpl_regs"]):
            regs[R_AUX] = rng.choice([C.KEY, C.BALL, C.BOX], size=b)
            regs[R_AUX + 1] = rng.integers(0, 6, size=b)
    return case


def committed_rows(ctl_in, ctl_out, t, b):
    """(T, B) bool: the pass-local rows each lane committed."""
    done = (ctl_out[1] - ctl_in[1]).long()
    return torch.arange(t, device=done.device)[:, None] < done[None, :]


def compare_policy_runs(got, want, ctl_in=None):
    """{name: lanes or entries that differ} between two `run_policy_kernel`
    results; under `ctl_in`, the trajectory only on the committed rows."""
    bad = {}
    names = ("words", "regs", "rsum", "episodes", "checksum")
    for name, g, w in zip(names, got[:5], want[:5]):
        if g.dtype != w.dtype or g.shape != w.shape:
            bad[name] = "dtype/shape"
        else:
            bad[name] = int((g.view(torch.int32) != w.view(torch.int32)).sum())
    if ctl_in is not None:
        bad["ctl"] = int((got[-1] != want[-1]).sum())
    if len(got) > 5 + (ctl_in is not None):
        t, b = got[5][1].shape
        mask = committed_rows(ctl_in, want[-1], t, b) if ctl_in is not None else torch.ones((t, b), dtype=torch.bool,
                                                                                             device=got[5][1].device)
        for k, (g, w) in enumerate(zip(got[5], want[5])):
            g, w = g.view(torch.int32), w.view(torch.int32)
            m = mask if g.ndim == 2 else mask[:, None, :]
            bad[f"traj{k}"] = int(((g != w) & m).sum())
    return {k: v for k, v in bad.items() if v}


POLICY_CONFIGS = [(8, 8, True), (16, 16, True), (25, 25, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("config", POLICY_CONFIGS)
def test_cuda_policy_kernel_hook_and_collect_match_twin(config, collect, ctl):
    """B2 with the pickup-target hook (8x8 and 16x16 at BT = 128) and
    hookless at 25x25 (BT = 64), in eval and collect mode, with and without
    random commit rows, on a ragged batch (a lane block's multiple + 32)
    against `plain_policy_rollout`: byte for byte, reward sums bit for bit,
    the spill on each lane's committed rows under `ctl`."""
    dev = _cuda()
    w_, h_, hook = config
    cfg = dataclasses.replace(make("MiniGrid-Empty-8x8-v0").config, width=w_, height=h_, max_steps=12)
    transition = "pickup_target" if hook else "base"
    b, t = 512 + 32, 24
    case = hooked_case(cfg, b, 21, hook)
    args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
    rng = np.random.default_rng(22)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (t, b)).astype(np.int32)).to(dev)
    ctl_in = None
    if ctl:
        ctl_in = torch.from_numpy(np.stack([rng.integers(0, 2, b), rng.integers(0, t + 1, b),
                                            rng.random(b) < 0.1]).astype(np.int32)).to(dev)
    weights = (tpr.train_weights_from_params if collect else tpr.eval_weights_from_params)(
        dyadic_flax_params(5), 7, device=dev)
    kw = dict(collect=collect, ctl=ctl_in, transition=transition)
    launches = tpr.policy_kernel_launches
    got = tpr.run_policy_kernel(*args, seeds, weights, cfg, **kw)
    assert tpr.policy_kernel_launches == launches + 1
    want = tpr.plain_policy_rollout(*args, seeds, weights, cfg, **kw)
    assert compare_policy_runs(got, want, ctl_in) == {}
    assert int(want[3].sum()) > 0


def _train_case(name, dev, b):
    env_id = ref.KC if name == "kc" else MR.N4
    env = MR.with_max_steps(make(env_id), 5 if name == "kc" else None)
    states, _ = env.reset_batch(prng.key(5, device=dev), b)
    return env, tfr.packed_init(env, states, "regen")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kc", "mr"])
def test_cuda_train_regen_rollout_matches_plain(name):
    """The collecting rollout under chunked regen, from one carry on the
    card (KeyCorridorS3R1 with `max_steps` cut to 5, chunk 8; MultiRoom-N4-S5,
    chunk 32): the kernel path against `build_fused_train_plain_rollout`,
    two calls, carries, metrics and the merged trajectory byte for byte."""
    dev = _cuda()
    env, carry = _train_case(name, dev, 1024)
    t, chunk = (32, 8) if name == "kc" else (96, 32)
    w = tpr.train_weights_from_params(dyadic_flax_params(6), 7, device=dev)
    runs = []
    for build in (tpr.build_fused_train_plain_rollout, tpr.build_fused_train_rollout):
        roll, c, out = build(env, t, mode="regen", regen_chunk=chunk), carry, []
        launches = tpr.policy_kernel_launches
        for i in range(2):
            c, traj, m = roll(w, prng.key(30 + i, device=dev), c)
            out.append((c, traj, m))
        runs.append(out)
        assert (tpr.policy_kernel_launches > launches) == (build is tpr.build_fused_train_rollout)
    for (c, traj, m), (pc, ptraj, pm) in zip(runs[1], runs[0]):
        for field, a, p in zip(c._fields, c, pc):
            assert torch.equal(a, p), field
        for field, a, p in zip(m._fields, m, pm):
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               p.view(torch.int32) if p.dtype == torch.float32 else p), field
        for k, (a, p) in enumerate(zip(traj, ptraj)):
            assert torch.equal(a.view(torch.int32), p.view(torch.int32)), k
    assert sum(int(m.episodes) for _, _, m in runs[1]) > 0
    if name == "kc":
        assert sum(int(m.reset_overlaps) for _, _, m in runs[1]) > 0
