"""The gradient kernel's wrapper and the fused train step on the card,
without JAX, so that the `gpu` tests also run on a machine with a card and
no JAX:

    python -m pytest --noconftest -o addopts="" tests/port/test_torch_grad_kernel.py -q

Without a CUDA device those tests skip with the reason: the kernel has no
CPU mode. The rest checks what the wrapper does before any launch (on
`meta` tensors) and the CPU path.

Tolerances of the kernel against `plain_grad_pass` on the card, with their
reasons: the two take the same bf16 products but sum them in f32 in other
orders (the kernel per sample split over lane tiles and splits, the plain
version in f32 GEMMs), and a one-ulp difference before a bf16 rounding of
h1, h2, dh2 or dh1 moves that value by one bf16 ulp. The f32 heads (wta,
ba) are held to 1e-4 of their largest entry, the loss sums to rtol 1e-4.
The torso (wt1, b1, wt2, b2) is held to 1e-3 of its largest entry: the
readings on an H100 are at most 6.6e-5 (wt2, at B = 131,072, T = 256),
while a kernel that left out one of G2's 16 lane splits or 2 time chunks
at the size tested here would read far above it (checked on the CPU by
`test_torso_bound_catches_a_dropped_g2_part`). Two launches on the same
inputs agree bit for bit (no float atomics).
"""

import functools

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import grad_kernel as tgk
from minigrid_tpu_torch.ops import policy_rollout as tpr
from minigrid_tpu_torch.parallel import train as TT
from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case

CPU = torch.device("cpu")
COEFS = (0.5, 0.01)  # value_coef, entropy_coef
HEAD_TOL, TORSO_TOL, SUMS_RTOL = 1e-4, 1e-3, 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _traj(b, t, device, seed=0):
    """A collected Empty-8x8 trajectory on `device` under flax-initialised
    train weights: `(weights, obs_w, actions, adv, ret)`."""
    cfg = EnvConfig(family="empty", width=8, height=8, max_steps=256, see_through_walls=True)
    case = random_packed_case(seed, 8, 8, b, cfg.max_steps)
    args = [torch.from_numpy(case[k]).to(device) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
    seeds = torch.from_numpy(np.random.default_rng(seed).integers(-(2**31), 2**31, (t, b)).astype(np.int32))
    model = ActorCritic(7, generator=torch.Generator().manual_seed(seed), device=CPU).to(device)
    w = tpr.train_weights_from_params(model, 7)
    *_, traj = tpr.run_policy_kernel(*args, seeds.to(device), w, cfg, collect=True)
    obs_w, actions, _, value, reward, done = traj
    ret = TT._trajectory_returns(reward, done, 0.99)
    return w, obs_w, actions, ret - value, ret


def _meta_operands(b=128, t=4):
    w = tpr.train_weights_from_params(dyadic_flax_params(0), 7, device="meta")
    obs = torch.zeros((t, 49, b), dtype=torch.int32, device="meta")
    act = torch.zeros((t, b), dtype=torch.int32, device="meta")
    f = torch.zeros((t, b), dtype=torch.float32, device="meta")
    return dict(w=w, obs_w=obs, actions=act, adv=f, ret=f.clone())


def _run(ops, num_actions=7):
    return tgk.run_grad_kernel(ops["w"], ops["obs_w"], ops["actions"], ops["adv"], ops["ret"], num_actions,
                               float(ops["adv"].numel()), *COEFS)


def test_wrapper_raises_off_cpu_without_cuda():
    with pytest.raises(ValueError, match="expected a CUDA device"):
        _run(_meta_operands())


@pytest.mark.parametrize(
    "field,bad,error,match",
    [
        ("obs_w", lambda x: x.to(torch.int64), TypeError, "obs_w has dtype"),
        ("actions", lambda x: x[:, :64], ValueError, "actions has shape"),
        ("adv", lambda x: x.to(torch.float64), TypeError, "adv has dtype"),
        ("ret", lambda x: x.t().contiguous().t(), ValueError, "ret is not contiguous"),
        ("wt1", lambda x: x.float(), TypeError, "wt1 has dtype"),
        ("wta", lambda x: x[:7], ValueError, "wta has shape"),
    ],
)
def test_wrapper_checks_operands_before_launch(field, bad, error, match):
    ops = _meta_operands()
    if field in ops:
        ops[field] = bad(ops[field])
    else:
        ops["w"] = ops["w"]._replace(**{field: bad(getattr(ops["w"], field))})
    with pytest.raises(error, match=match):
        _run(ops)


@pytest.mark.parametrize(
    "b,num_actions,match", [(96, 7, "multiple of 64"), (128, 8, "critic"), (128, 0, "critic")]
)
def test_wrapper_rejects_batches_and_heads_it_does_not_take(b, num_actions, match):
    ops = _meta_operands(b=b)
    with pytest.raises(ValueError, match=match):
        _run(ops, num_actions)


def test_wrapper_takes_plain_pass_on_cpu():
    w, obs_w, actions, adv, ret = _traj(64, 4, CPU)
    before = tgk.grad_kernel_launches
    got = tgk.run_grad_kernel(w, obs_w, actions, adv, ret, 7, 256.0, *COEFS)
    want = tgk.plain_grad_pass(w, obs_w, actions, adv, ret, 7, 256.0, *COEFS)
    assert tgk.grad_kernel_launches == before
    for g, x in zip((*got[0], got[1]), (*want[0], want[1])):
        assert g.dtype == torch.float32 and torch.equal(g, x)
    gw, sums = tgk.build_grad_kernel(7, 7, 4, 64, 256.0, *COEFS)(w, obs_w, actions, adv, ret)
    assert [g.dtype for g in gw] == [x.dtype for x in w] and torch.equal(gw.wta, want[0].wta)
    assert torch.equal(gw.wt1, want[0].wt1.to(torch.bfloat16))


@pytest.mark.parametrize("b,splits,lanes", [(64, 1, 64), (1024, 16, 64), (131_072, 64, 2048), (64 * 100, 50, 128)])
def test_splits_cover_the_batch_in_whole_steps(b, splits, lanes):
    assert tgk.grad_splits(b) == (splits, lanes)
    assert lanes % tgk.G2_KSTEP == 0 and (splits - 1) * lanes < b <= splits * lanes


@pytest.mark.parametrize("b", [64, 1024, 64 * 67, 131_072])
@pytest.mark.parametrize("view", [3, 5, 7])
def test_g2_grid_covers_every_output_and_sample_once(b, view):
    """G2's grid as the kernel walks it: each split's lanes [s·lanes,
    min((s+1)·lanes, B)) in whole 64-lane stages cover every lane once, and
    the dW1ᵀ tiles (128 feature rows each, padded past V²·20) and the two
    dW2 tiles cover every output row once."""
    splits, lanes = tgk.grad_splits(b)
    seen = np.zeros(b, dtype=np.int64)
    for s in range(splits):
        lo, hi = s * lanes, min((s + 1) * lanes, b)
        assert hi > lo and (hi - lo) % tgk.G2_KSTEP == 0
        for l0 in range(lo, hi, tgk.G2_KSTEP):
            seen[l0 : l0 + tgk.G2_KSTEP] += 1
    assert (seen == 1).all()
    nf, w1_tiles, w2_tiles = tgk.g2_tiles(view)
    assert w1_tiles * tgk.G2_TILE == nf >= view * view * 20 > nf - tgk.G2_TILE
    assert w2_tiles * tgk.G2_TILE == tpr.HIDDEN


@pytest.mark.parametrize("view", [3, 5, 7])
def test_g1_shared_memory_fits_one_block(view):
    stages, smem = tgk.grad_plan(view)
    assert smem == tgk.grad_smem_bytes(view) <= tpr._SMEM_LIMIT
    assert tpr.MIN_STAGES <= stages <= tpr.MAX_STAGES
    assert smem + tpr.CHUNK_BYTES > tpr._SMEM_LIMIT  # the ring takes what is left
    if view == 7:
        assert stages == 5


@functools.lru_cache(maxsize=None)
def _cpu_traj_1024x16():
    return _traj(1024, 16, CPU, seed=3)


@pytest.mark.parametrize("part", ["lane split", "time chunk"])
def test_torso_bound_catches_a_dropped_g2_part(part):
    """The share of dW1 and dW2 that one of G2's parts carries in the
    trajectory of `test_cuda_grad_kernel_matches_plain_pass` (the reading
    of a kernel that left it out) lies well above TORSO_TOL."""
    w, obs_w, actions, adv, ret = _cpu_traj_1024x16()
    splits, lanes = tgk.grad_splits(1024)
    steps, cols = (slice(None), slice(1024 - lanes, 1024)) if part == "lane split" else (
        slice(0, tgk.TIME_CHUNK), slice(None))
    args = (7, float(1024 * 16), *COEFS)
    full, _ = tgk.plain_grad_pass(w, obs_w, actions, adv, ret, *args)
    left, _ = tgk.plain_grad_pass(w, obs_w[steps, :, cols], actions[steps, cols], adv[steps, cols],
                                  ret[steps, cols], *args)
    for name in ("wt1", "wt2"):
        reading = float(getattr(left, name).abs().max() / getattr(full, name).abs().max())
        assert reading > 10 * TORSO_TOL, (part, name, reading)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(1024, 16), (64 * 67, 12)])
def test_cuda_grad_kernel_matches_plain_pass(b, t):
    """At B = 64·67 the last of G2's 34 splits holds one 64-lane stage of
    its 128, and T = 12 leaves a ragged last time chunk."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    w, obs_w, actions, adv, ret = _traj(b, t, dev, seed=3)
    denom = float(b * t)
    before = tgk.grad_kernel_launches
    gw, sums = tgk.run_grad_kernel(w, obs_w, actions, adv, ret, 7, denom, *COEFS)
    want_gw, want_sums = tgk.plain_grad_pass(w, obs_w, actions, adv, ret, 7, denom, *COEFS)
    torch.cuda.synchronize()
    assert tgk.grad_kernel_launches == before + 1
    for name, g, x in zip(tpr.EvalWeights._fields, gw, want_gw):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        rel = float((g - x).abs().max() / (x.abs().max() + 1e-9))
        assert rel < (HEAD_TOL if name in ("wta", "ba") else TORSO_TOL), (name, rel)
    assert bool(torch.isfinite(sums).all())
    torch.testing.assert_close(sums, want_sums, rtol=SUMS_RTOL, atol=0)


@pytest.mark.gpu
def test_cuda_grad_kernel_repeats_bit_for_bit():
    dev = _cuda()
    w, obs_w, actions, adv, ret = _traj(2048, 12, dev, seed=4)  # a ragged last time chunk
    runs = [tgk.run_grad_kernel(w, obs_w, actions, adv, ret, 7, 2048.0 * 12, *COEFS) for _ in range(2)]
    for a, b in zip((*runs[0][0], runs[0][1]), (*runs[1][0], runs[1][1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_cuda_train_step_launches_each_kernel_once_per_step():
    """Empty-8x8 regen: each train step launches the collecting policy
    kernel once and the gradient kernel once, moves the params and gives a
    finite loss."""
    dev = _cuda()
    env = make("MiniGrid-Empty-8x8-v0")
    ts = TT.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    carry = tfr.packed_init(env, env.reset_batch(key(0), 1024)[0], "regen")
    step = TT.build_fused_train_step(env, 32, mode="regen")
    p0 = TT.flatten_params(ts.params.flax_params())
    before = (tpr.policy_kernel_launches, tgk.grad_kernel_launches)
    for i in range(2):
        ts, carry, metrics = step(ts, carry, key(1 + i))
    assert (tpr.policy_kernel_launches, tgk.grad_kernel_launches) == (before[0] + 2, before[1] + 2)
    assert bool(torch.isfinite(metrics["loss"])) and int(metrics["env_steps"]) == 1024 * 32
    assert float((TT.flatten_params(ts.params.flax_params()) - p0).abs().max()) > 0
