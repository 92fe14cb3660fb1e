"""MultiRoom in the port against the JAX package, and on a card the slice's
kernels against their plain versions.

Against the JAX package, on the same numpy-made keys, byte for byte, its
outputs held in files that `make_multiroom_reference.py` writes from it
(its MultiRoom generator takes 25-70 s to compile on a CPU, N6's
minutes; each `slow` test recomputes its file live and compares):
  * the plan (`_plan_batched`: the room-chain loop's plain version and
    the draws around it, every `Plan` field) and the packed layout
    (`generate_packed`) of N2-S4 and N4-S5, against the JAX package's
    `vmap(_plan)` and `generate_packed` (and at N2-S4 `vmap(generate)`,
    against the port's `generate`), in
    `data/multiroom_plan_layout_b64.npz`;
  * N6's plan and layout against `data/multiroom_n6_b64.npz`;
  * the packed paint helpers, rectangles past the grid included;
  * chunked regen at N2-S4, B = 128, two calls of T = 48: the random
    policy against `build_packed_xla_rollout(mode="regen",
    regen_chunk=8)`, with `max_steps` as registered (every lane truncates
    at step 40) and cut to 5 (lanes end two episodes in a chunk, so steps
    freeze and re-enter: `reset_overlaps > 0`); the actor in the loop
    under dyadic weights (`testing.dyadic_flax_params`) against
    `build_policy_eval_rollout(backend="xla", regen_chunk=8)` at B = 64,
    T = 16, `max_steps` 5; in `data/multiroom_n2s4_regen.npz`, with the
    port's carry each case starts from (the port's own carry must equal
    it).
Carries, `episodes`, `obs_checksum` and `reset_overlaps` are byte-exact;
`total_reward` gets rtol 1e-6 for the batch-sum order (ROADMAP.md §C).

JAX is imported only by the tests that recompute a file, so the `gpu`
tests (the room-chain kernel, B1 and B2 under the commit rows at 25x25,
and the whole chunked-regen steps) also run on a machine with a card and
without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/port/test_torch_multiroom.py -q
"""

import dataclasses

import make_multiroom_reference as ref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.envs import multiroom as tmr
from minigrid_tpu_torch.ops import chunked_regen as tcr
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import gen_kernel as tgk
from minigrid_tpu_torch.ops import packed_gen as PG
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.ops.packing import R_MISSION, key_rows
from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, carry_to_numpy, state_to_numpy

N2, N4, N6 = (f"MiniGrid-MultiRoom-{n}-v0" for n in ("N2-S4", "N4-S5", "N6"))
B = 64
CPU = torch.device("cpu")


def _keys(b=B, seed=ref.PLAN_SEED):
    return ref.plan_keys(b, seed)


def _torch_keys(k, device=CPU):
    return torch.from_numpy(k.astype(np.int64)).to(device)


def _env(env_id=N2, max_steps=None):
    env = make(env_id)
    if max_steps is not None:
        env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))
    return env


def _port_plan_and_layout(env_id, k):
    cfg = make(env_id).config
    plan = tmr._plan_batched(_torch_keys(k), cfg)
    words, regs = tmr.generate_packed(_torch_keys(k), cfg)
    assert words.dtype == regs.dtype == torch.int32
    c = plan.chain
    got = {
        "k_reset": plan.k_reset, "tops": c.tops, "sizes": c.sizes, "entry": c.entry, "count": c.count,
        "door_colors": plan.door_colors, "k_agent": plan.k_agent, "agent_dir": plan.agent_dir,
        "k_goal": plan.k_goal, "words": words, "regs": regs,
    }
    got = {n: v.numpy() for n, v in got.items()}
    for n in ("k_reset", "k_agent", "k_goal"):
        got[n] = got[n].astype(np.uint32)
    return got


def _assert_same_fields(got, want):
    for name in ref.FIELDS:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _plan_file(env_id):
    tag = {v: k for k, v in ref.PLAN_IDS.items()}[env_id]
    return {name[len(tag) + 1:]: v for name, v in ref.load(ref.PLAN_PATH).items() if name.startswith(tag + "/")}


@pytest.mark.parametrize("env_id", [N2, N4])
def test_plan_and_layout_match_jax(env_id):
    """Against the JAX package's outputs in `ref.PLAN_PATH`."""
    with_states = env_id == N2
    want = _plan_file(env_id)
    got = _port_plan_and_layout(env_id, _keys())
    _assert_same_fields(got, want)
    assert (want["count"] == make(env_id).config.max_num_rooms).all()
    assert (got["regs"][R_MISSION] == tmr.MISSION).all()
    if with_states:
        states = state_to_numpy(tmr.generate(_torch_keys(_keys()), make(env_id).config))
        for name in STATE_FIELDS:
            assert states[name].dtype == want[f"state_{name}"].dtype, name
            np.testing.assert_array_equal(states[name], want[f"state_{name}"], err_msg=name)


def _n6_file():
    return dict(np.load(ref.PATH))


def test_n6_plan_and_layout_match_the_jax_reference_file():
    want = _n6_file()
    np.testing.assert_array_equal(want["keys"], ref.keys())
    _assert_same_fields(_port_plan_and_layout(N6, ref.keys()), want)
    assert (want["count"] == 6).all()


@pytest.mark.slow
def test_plan_and_layout_reference_file_matches_jax():
    pytest.importorskip("jax")
    ref.assert_same_arrays(ref.load(ref.PLAN_PATH), ref.jax_plan_layouts())


@pytest.mark.slow
def test_n6_reference_file_matches_jax():
    pytest.importorskip("jax")
    _assert_same_fields(_n6_file(), ref.jax_plan_and_layout(N6, ref.keys()))


def test_mission_and_ids_carry_the_jax_table_and_configs():
    import minigrid_tpu
    from minigrid_tpu.envs import missions as jmissions

    assert tmr.MISSION == 16 == jmissions._TEMPLATES.index("traverse the rooms to get to the goal")
    for env_id in (N2, N4, N6):
        env = make(env_id)
        assert dataclasses.asdict(env.config) == dataclasses.asdict(minigrid_tpu.make(env_id).config)
        assert env.transition == "base"
        assert tfr.get_packed_generator(env) is tmr.generate_packed


def _paint_inputs(b=32, seed=3):
    """Corners `(x0, y0, x1, y1)` on and past every edge of a 9x7 grid,
    some rectangles empty, and a lane mask."""
    rng = np.random.default_rng(seed)
    x0, y0 = (rng.integers(-3, 10, b).astype(np.int32) for _ in range(2))
    x1, y1 = (rng.integers(-1, 13, b).astype(np.int32) for _ in range(2))
    return x0, y0, x1, y1, rng.random(b) < 0.7


def test_paint_helpers_match_jax():
    """`empty_words`, `paint_rect_words` and `outline_rect_words` on a 9x7
    grid, rectangles reaching past every edge, empty and negative ones."""
    jax = pytest.importorskip("jax")
    from minigrid_tpu.ops import packed_gen as JPG

    x0, y0, x1, y1, active = _paint_inputs()
    w, h, b = 9, 7, x0.shape[0]

    @jax.jit
    def run(x0, y0, x1, y1, active):
        xs, ys = JPG.xy_iota(h, w)
        words = JPG.empty_words(h, w, b)
        painted = JPG.paint_rect_words(words, xs, ys, x0, y0, x1, y1, 7)
        return words, painted, JPG.outline_rect_words(painted, xs, ys, x0, y0, x1 - x0, y1 - y0, 2, active=active)

    want = [np.asarray(a) for a in run(x0, y0, x1, y1, active)]
    t = torch.from_numpy
    xs, ys = PG.xy_iota(h, w)
    words = PG.empty_words(h, w, b)
    painted = PG.paint_rect_words(words, xs, ys, t(x0), t(y0), t(x1), t(y1), 7)
    outlined = PG.outline_rect_words(painted, xs, ys, t(x0), t(y0), t(x1 - x0), t(y1 - y0), 2, active=t(active))
    for name, g, wnt in zip(("empty", "painted", "outlined"), (words, painted, outlined), want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), wnt, err_msg=name)
    assert (want[2] == 2).any() and (want[1] == 7).any()


# ---------------------------------------------------------------------------
# Chunked regen against the JAX package
# ---------------------------------------------------------------------------

REGEN_B = 128
REGEN_T = 48
REGEN_CHUNK = ref.REGEN_CHUNK
REGEN_CASES = {"registered": None, "max5": 5}
POLICY_B = 64
POLICY_T = 16
POLICY_MAX_STEPS = 5


def _actions(b=REGEN_B, t=REGEN_T, seed=0):
    return ref.actions(b, t, seed)


def _port_carry(env, b, device=CPU, seed=5):
    return tfr.packed_init(env, env.reset_batch(key(seed, device=device), b)[0], "regen")


def _two_calls(step, carry, source):
    """[(carry, metrics)] * 2 of a carry surface."""
    out = []
    for _ in range(2):
        carry, metrics = step(source, carry)
        out.append((carry, metrics))
    return out


def _file_case(name, carry):
    """The JAX package's two calls of `ref.REGEN_CASES[name]` from
    `ref.REGEN_PATH` as [(carry arrays, metrics arrays)] * 2, after checking
    that the file's input carry is the port's `carry`."""
    arrays = {k[len(name) + 1:]: v for k, v in ref.load(ref.REGEN_PATH).items() if k.startswith(name + "/")}
    for field, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, arrays[f"in/{field}"], err_msg=f"input carry {field}")
    return [({f: arrays[f"call{i}/carry/{f}"] for f in ref.CARRY_FIELDS},
             {f: arrays[f"call{i}/metrics/{f}"] for f in ref.METRIC_FIELDS}) for i in range(2)]


def _assert_same_calls(got, want):
    for i, ((c, m), (jc, jm)) in enumerate(zip(got, want)):
        for name in jc:
            np.testing.assert_array_equal(c[name], jc[name], err_msg=f"call {i} {name}")
        for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
            assert getattr(m, name).dtype == torch.int32, name
            assert int(getattr(m, name)) == int(jm[name]), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm["total_reward"]), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(REGEN_CASES))
def test_random_policy_chunked_regen_matches_jax_packed_xla_rollout(case):
    """Against the JAX package's `build_packed_xla_rollout` in `ref.REGEN_PATH`."""
    max_steps = REGEN_CASES[case]
    env = _env(N2, max_steps)
    carry = _port_carry(env, REGEN_B)
    want = _file_case(f"random_{case}", carry)
    passes = tcr.reentry_passes
    step = tfr.build_fused_rollout(env, REGEN_T, mode="regen", regen_chunk=REGEN_CHUNK, as_carry=True,
                                   actions_override=_actions())
    got = [(carry_to_numpy(c), m) for c, m in _two_calls(step, carry, None)]
    _assert_same_calls(got, want)
    metrics = [m for _, m in got]
    assert sum(int(m.episodes) for m in metrics) >= REGEN_B  # every lane reset at least once
    if max_steps is not None:
        assert sum(int(m.reset_overlaps) for m in metrics) > 0
        assert tcr.reentry_passes > passes


def test_policy_eval_chunked_regen_matches_jax_xla():
    """Against the JAX package's `build_policy_eval_rollout(backend="xla")`
    in `ref.REGEN_PATH`."""
    env = _env(N2, POLICY_MAX_STEPS)
    carry = _port_carry(env, POLICY_B, seed=7)
    want = _file_case("policy_max5", carry)
    params = dyadic_flax_params(ref.POLICY_PARAMS_SEED)
    step = tpr.build_policy_eval_rollout(env, params, POLICY_T, mode="regen", as_carry=True, regen_chunk=REGEN_CHUNK)
    got = [(carry_to_numpy(c), m) for c, m in _two_calls(step, carry, prng.key(11, device=CPU))]
    _assert_same_calls(got, want)
    assert sum(int(m.reset_overlaps) for _, m in got) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(ref.REGEN_CASES))
def test_regen_reference_file_matches_jax(name):
    pytest.importorskip("jax")
    want = ref.jax_regen_case(name)
    ref.assert_same_arrays({k: v for k, v in ref.load(ref.REGEN_PATH).items() if k.startswith(name + "/")}, want)


# ---------------------------------------------------------------------------
# What the policy rollouts take on a random layout
# ---------------------------------------------------------------------------


def test_policy_rollouts_take_random_layouts_in_both_modes():
    """MultiRoom regen with `collect=True`, and KeyCorridor (the
    pickup-target hook) in regen mode, build and run: the collecting
    rollout, policy evaluation and the collecting twin under the commit
    rows."""
    env = make(N4)
    assert tpr.policy_lane_block(env.config) == 64  # 25x25: 128 lanes of grids do not fit
    for mode in ("regen", "cached"):
        for collect in (False, True):
            assert tpr.policy_rollout_supported(env, mode, collect=collect)
    w = tpr.train_weights_from_params(dyadic_flax_params(0), 7, device=CPU)
    n2 = _env(N2, 3)
    carry, traj, metrics = tpr.build_fused_train_rollout(n2, 8, mode="regen", regen_chunk=4)(
        w, prng.key(1, device=CPU), _port_carry(n2, 4)
    )
    assert tuple(traj[0].shape) == (8, 49, 4) and int(metrics.total_steps) == 32 and int(metrics.episodes) > 0
    kc = make("MiniGrid-KeyCorridorS3R1-v0")
    step = tpr.build_policy_eval_rollout(kc, dyadic_flax_params(0), 8, mode="regen", as_carry=True)
    _, m = step(prng.key(2, device=CPU), _port_carry(kc, 4))
    assert int(m.total_steps) == 32
    cfg = env.config
    case = random_packed_case(1, cfg.width, cfg.height, 4, cfg.max_steps)
    args = [torch.from_numpy(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
    out = tpr.plain_policy_rollout(*args, torch.zeros((2, 4), dtype=torch.int32), w, cfg, collect=True,
                                   ctl=torch.zeros((3, 4), dtype=torch.int32))
    assert len(out) == 7 and tuple(out[6].shape) == (3, 4) and (out[6][1] > 0).all()


# ---------------------------------------------------------------------------
# On a card: the slice's kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the policy twin's f32 GEMMs in full f32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", [N2, N4, N6])
def test_cuda_mr_chain_kernel_matches_plain(env_id):
    """B5 on the generator's own retry keys and room counts, 4,096 lanes:
    the chain, its count, the attempts and the rows drawn."""
    dev = _cuda()
    cfg = make(env_id).config
    keys = _torch_keys(_keys(4096, seed=9), dev)
    k, _ = prng.split(keys, 2).unbind(1)
    ks = prng.split(k, 6).unbind(1)
    nr = prng.randint(ks[0], cfg.min_num_rooms, cfg.max_num_rooms + 1)[None].contiguous()
    launches = tgk.mr_chain_kernel_launches
    got = tgk.run_mr_chain_kernel(key_rows(ks[1]), nr, cfg, tmr.MAX_ATTEMPTS)
    assert tgk.mr_chain_kernel_launches == launches + 1
    want = tgk.plain_mr_chain(key_rows(ks[1]), nr, cfg, tmr.MAX_ATTEMPTS)
    for name, g, w in zip(("rooms", "count", "attempts", "rows"), got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape, name
        assert torch.equal(g, w), name
    assert bool((want[1] == nr).all())


def _chain_case(case, dev):
    """The room-chain kernel's arguments for a case: the generator's own
    retry keys and room counts (`_plan`'s draws) for 1, 33 and 4,096 + 77
    lanes of N4-S5 and N6; N6 at max_attempts 1 and 3 (lanes stop short
    of their count); an `EnvConfig` with max_num_rooms 8 (N6's grid, 6 to 8
    rooms); and N6's tail, the 64 lanes of 2,048 that take the most
    attempts."""
    env_id, b, max_attempts, nmax = {
        "n4_b1": (N4, 1, tmr.MAX_ATTEMPTS, None), "n4_b33": (N4, 33, tmr.MAX_ATTEMPTS, None),
        "n4_ragged": (N4, 4096 + 77, tmr.MAX_ATTEMPTS, None), "n6_ragged": (N6, 4096 + 77, tmr.MAX_ATTEMPTS, None),
        "n6_attempts1": (N6, 1024, 1, None), "n6_attempts3": (N6, 1024, 3, None),
        "nmax8": (N6, 512, tmr.MAX_ATTEMPTS, 8), "n6_tail": (N6, 2048, tmr.MAX_ATTEMPTS, None),
    }[case]
    cfg = make(env_id).config
    if nmax is not None:
        cfg = dataclasses.replace(cfg, max_num_rooms=nmax)
    keys = _torch_keys(_keys(b, seed=b + max_attempts), dev)
    k, _ = prng.split(keys, 2).unbind(1)
    ks = prng.split(k, 6).unbind(1)
    retry = key_rows(ks[1])
    nr = prng.randint(ks[0], cfg.min_num_rooms, cfg.max_num_rooms + 1)[None].contiguous()
    if case == "n6_tail":
        attempts = tgk.plain_mr_chain(retry, nr, cfg, max_attempts)[2][0]
        tail = torch.argsort(attempts, descending=True, stable=True)[:64]
        retry, nr = retry[:, tail].contiguous(), nr[:, tail].contiguous()
    return retry, nr, cfg, max_attempts


CHAIN_CASES = ("n4_b1", "n4_b33", "n4_ragged", "n6_ragged", "n6_attempts1", "n6_attempts3", "nmax8", "n6_tail")


def test_chain_cases_hold_what_they_name():
    """On the CPU, through the plain version: lanes stop short of their
    count at max_attempts 1 and 3, and max_num_rooms 8 places chains of 8
    rooms (the GPU test checks N6's tail, whose choice takes seconds
    here)."""
    for case in ("n6_attempts1", "n6_attempts3", "nmax8"):
        args = _chain_case(case, CPU)
        _, count, attempts, _ = tgk.plain_mr_chain(*args)
        if case.startswith("n6_attempts"):
            assert int(attempts.max()) == args[3] and bool((count < args[1]).any())
        else:
            assert int(count.max()) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_cuda_mr_chain_kernel_plans_match_plain(case):
    """The kernel on each case, byte for byte against the plain version:
    the chain, its count, the attempts and the rows; two launches agree.
    N6's tail takes at least 10 attempts a lane."""
    dev = _cuda()
    args = _chain_case(case, dev)
    got = tgk.run_mr_chain_kernel(*args)
    again = tgk.run_mr_chain_kernel(*args)
    want = tgk.plain_mr_chain(*args)
    for name, g, a, w in zip(("rooms", "count", "attempts", "rows"), got, again, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape, name
        assert torch.equal(g, w), name
        assert torch.equal(a, g), name
    if case == "n6_tail":
        assert int(want[2].min()) >= 10


def _ctl_case(cfg, b, t, seed):
    """Random packed states and commit rows: some lanes consumed, frozen,
    or part-way or all the way through the chunk."""
    case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    rng = np.random.default_rng(seed)
    ctl = np.stack([rng.integers(0, 2, b), rng.integers(0, t + 1, b), (rng.random(b) < 0.1)]).astype(np.int32)
    return case, ctl


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-8x8-v0", N4])
def test_cuda_kernels_under_commit_rows_match_plain(env_id):
    """B1 `<kHookNone, kCtl>` and B2 with `kCtl` (BT = 128 at 8x8, 64 at
    25x25) against their twins on random states and commit rows; `max_steps`
    cut to 12 so that lanes reset, freeze and finish the chunk."""
    dev = _cuda()
    cfg = dataclasses.replace(make(env_id).config, max_steps=12)
    b, t = 512, 24
    case, ctl = _ctl_case(cfg, b, t, 13)
    args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
    ctl = torch.from_numpy(ctl).to(dev)
    rng = np.random.default_rng(14)
    actions = torch.from_numpy(rng.integers(0, 7, (t, b)).astype(np.int32)).to(dev)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (t, b)).astype(np.int32)).to(dev)
    w = tpr.eval_weights_from_params(dyadic_flax_params(5), cfg.agent_view_size, device=dev)
    before = tfr.rollout_kernel_launches, tpr.policy_kernel_launches
    runs = [
        (tfr.run_rollout_kernel(*args, actions, cfg, ctl=ctl), tfr.plain_rollout(*args, actions, cfg, ctl=ctl)),
        (tpr.run_policy_kernel(*args, seeds, w, cfg, ctl=ctl), tpr.plain_policy_rollout(*args, seeds, w, cfg, ctl=ctl)),
    ]
    assert (tfr.rollout_kernel_launches, tpr.policy_kernel_launches) == (before[0] + 1, before[1] + 1)
    for got, want in runs:
        for name, g, wn in zip(("words", "regs", "rsum", "episodes", "checksum", "ctl"), got, want):
            assert g.dtype == wn.dtype and g.shape == wn.shape, name
            gb, wb = (g.view(torch.int32), wn.view(torch.int32)) if g.dtype == torch.float32 else (g, wn)
            assert torch.equal(gb, wb), name
        assert int(want[3].sum()) > 0 and int(want[5][2].sum()) > int(ctl[2].sum())  # resets and new freezes


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["random", "policy"])
@pytest.mark.parametrize("case", sorted(REGEN_CASES))
def test_cuda_multiroom_regen_step_matches_plain(case, path):
    """From one N4-S5 carry on the card: the kernel path (B1 or B2 under the
    commit rows, B5 in the template refresh) against the plain path, byte
    for byte, reward sums bit for bit."""
    dev = _cuda()
    env = _env(N4, REGEN_CASES[case])
    carry = _port_carry(env, 1024, dev)
    if path == "random":
        kw = dict(mode="regen", regen_chunk=REGEN_CHUNK, as_carry=True, actions_override=_actions(1024))
        builds, source = (tfr.build_fused_rollout, tfr.build_packed_plain_rollout), None
        args = (env, REGEN_T)
    else:
        kw = dict(mode="regen", regen_chunk=REGEN_CHUNK, as_carry=True)
        builds, source = (tpr.build_policy_eval_rollout, tpr.build_policy_eval_plain_rollout), prng.key(3, device=dev)
        args = (env, dyadic_flax_params(6), REGEN_T)
    launches = tgk.mr_chain_kernel_launches
    want = _two_calls(builds[1](*args, **kw), carry, source)
    assert tgk.mr_chain_kernel_launches == launches
    got = _two_calls(builds[0](*args, **kw), carry, source)
    assert tgk.mr_chain_kernel_launches > launches
    for (c, m), (pc, pm) in zip(got, want):
        for name, a, b in zip(c._fields, c, pc):
            assert torch.equal(a, b), name
        for name, a, b in zip(m._fields, m, pm):
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b), name
    assert sum(int(m.episodes) for _, m in got) > 0
    if REGEN_CASES[case] is not None:
        assert sum(int(m.reset_overlaps) for _, m in got) > 0
