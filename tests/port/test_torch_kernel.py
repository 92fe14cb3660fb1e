"""The CUDA kernels' wrappers (the rollout kernel and the probe). This file imports no JAX, so its
`gpu` tests also run on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" tests/port/test_torch_kernel.py -q

Without a CUDA device those tests skip with the reason: the kernel has no
CPU mode. The rest checks what the wrapper does before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.testing import hooked_packed_case, random_packed_case

OPERANDS = ("words", "regs", "tmpl_words", "tmpl_regs")


def _cfg(width, height, see_through_walls):
    return EnvConfig(
        family="empty", width=width, height=height, max_steps=4 * width * height,
        see_through_walls=see_through_walls,
    )


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def test_kernel_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches the plain twin: the wrapper raises."""
    cfg = _cfg(8, 8, True)
    case = random_packed_case(0, 8, 8, 32, cfg.max_steps)
    args = [torch.from_numpy(case[k]).to("meta") for k in OPERANDS]
    actions = torch.zeros((4, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tfr.run_rollout_kernel(*args, actions, cfg)


def test_probe_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(np.random.default_rng(0).integers(-1000, 1000, _build.PROBE_SHAPE, dtype=np.int32))
    before = _build.probe_launches
    y = _build.probe(x)
    assert y.dtype == torch.int32 and torch.equal(y, x + 1)
    assert _build.probe_launches == before


def test_probe_wrapper_raises_off_cpu_without_cuda():
    with pytest.raises(ValueError, match="expected a CUDA device"):
        _build.probe(torch.zeros(_build.PROBE_SHAPE, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize(
    "size,lanes", [((8, 8), 128), ((16, 16), 128), ((25, 25), 64), ((40, 40), 32), ((80, 80), None)]
)
def test_kernel_lane_block_fits_shared_memory(size, lanes):
    cfg = _cfg(*size, False)
    if lanes is None:
        with pytest.raises(ValueError, match="shared memory"):
            tfr.kernel_lane_block(cfg)
    else:
        assert tfr.kernel_lane_block(cfg) == lanes


@pytest.mark.parametrize("view", [1, 4, 33])
def test_kernel_rejects_view_sizes_it_does_not_take(view):
    with pytest.raises(ValueError, match="view size"):
        tfr.kernel_lane_block(dataclasses.replace(_cfg(8, 8, False), agent_view_size=view))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "width,height,see_through_walls",
    [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, False), (25, 25, False)],
)
def test_cuda_kernel_matches_plain_twin(width, height, see_through_walls):
    """Words, registers, episodes and checksum byte-exact; per-lane reward
    sums bit-identical."""
    dev = _cuda()
    cfg = _cfg(width, height, see_through_walls)
    b, t = 4096, 64
    case = random_packed_case(width * height, width, height, b, cfg.max_steps)
    args = [torch.from_numpy(case[k]).to(dev) for k in OPERANDS]
    actions = np.random.default_rng(1).integers(0, 7, (t, b)).astype(np.int32)
    actions = torch.from_numpy(actions).to(dev)
    before = tfr.rollout_kernel_launches
    got = tfr.run_rollout_kernel(*args, actions, cfg)
    want = tfr.plain_rollout(*args, actions, cfg)
    torch.cuda.synchronize()
    assert tfr.rollout_kernel_launches == before + 1
    for name, g, w in zip(("words", "regs", "rsum", "episodes", "checksum"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_cuda_carry_surface_matches_plain_twin():
    """Empty-8x8 regen through `build_fused_rollout` on the card equals the
    plain twin under the same generator seed, rng chain included."""
    dev = _cuda()
    env = make("MiniGrid-Empty-8x8-v0")
    carry = tfr.packed_init(env, env.reset_batch(key(0, device=dev), 8192)[0], "regen")
    out = []
    for build in (tfr.build_fused_rollout, tfr.build_packed_plain_rollout):
        step = build(env, 128, mode="regen", as_carry=True)
        out.append(step(torch.Generator(device=dev).manual_seed(3), carry))
    (ck, mk), (cp, mp) = out
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    for a, b in zip(mk, mp):
        assert torch.equal(a, b)
    assert int(mk.episodes) > 0


@pytest.mark.gpu
def test_cuda_probe_kernel_matches_plain_and_runs_once_per_device():
    """`load_library` launches the probe once per device and process; the
    probe's wrapper counts each launch and computes `x + 1`."""
    dev = _cuda()
    _build.load_library(dev)
    before = _build.probe_launches
    _build.load_library(dev)
    assert _build.probe_launches == before
    x = np.random.default_rng(2).integers(-(2**31), 2**31 - 1, _build.PROBE_SHAPE, dtype=np.int32)
    x = torch.from_numpy(x).to(dev)
    y = _build.probe(x)
    assert _build.probe_launches == before + 1
    assert torch.equal(y, x + 1)


# The rollout kernel's plans, forced: one and four threads a lane on
# 16-bit cells, and the generic kernel on int32 cells.
PLANS = {
    "cells16_t1": dict(THREADS_PER_LANE=(1,)),
    "cells16_t4": dict(THREADS_PER_LANE=(4,)),
    "generic_int32": dict(CELL16_FAMILIES=frozenset()),
}
# Transition -> (an id of its family at 8x8 or the nearest, at 16x16).
PLAN_CASES = {
    "base": ("MiniGrid-Empty-8x8-v0", "MiniGrid-Empty-16x16-v0"),
    "pickup_target": ("MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-KeyCorridorS6R3-v0"),
    "fetch": ("MiniGrid-Fetch-8x8-N3-v0",) * 2,
    "gotodoor": ("MiniGrid-GoToDoor-8x8-v0",) * 2,
    "gotoobject": ("MiniGrid-GoToObject-8x8-N2-v0",) * 2,
    "putnear": ("MiniGrid-PutNear-8x8-N3-v0",) * 2,
    "redbluedoors": ("MiniGrid-RedBlueDoors-8x8-v0",) * 2,
    "memory": ("MiniGrid-MemoryS7-v0",) * 2,
    "unlock": ("MiniGrid-Unlock-v0",) * 2,
    "dynamicobstacles": ("MiniGrid-Dynamic-Obstacles-8x8-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("size", [8, 16])
@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("transition", sorted(PLAN_CASES))
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_cuda_rollout_kernel_plans_match_plain(plan, transition, ctl, size, monkeypatch):
    """Each plan under every hook, with and without commit rows, at 8x8
    and 16x16 on a ragged batch (2,048 + 32 lanes), byte for byte (reward
    sums bit for bit)."""
    dev = _cuda()
    cfg = make(PLAN_CASES[transition][size == 16]).config
    cfg = dataclasses.replace(cfg, width=size, height=size, max_steps=12)
    b, t = 2048 + 32, 24
    if transition == "base":
        case = random_packed_case(size, size, size, b, cfg.max_steps)
    else:
        case = hooked_packed_case(size, transition, size, size, b, cfg.max_steps, cfg.n_obstacles or 0)
    args = [torch.from_numpy(case[k]).to(dev) for k in OPERANDS]
    rng = np.random.default_rng(size)
    actions = torch.from_numpy(rng.integers(-1, 8, (t, b)).astype(np.int32)).to(dev)
    ctl_in = None
    if ctl:
        rows = np.stack([rng.integers(0, 2, b), rng.integers(0, t + 1, b), rng.random(b) < 0.1]).astype(np.int32)
        rows[:, : b // 2] = 0
        ctl_in = torch.from_numpy(rows).to(dev)
    for name, value in PLANS[plan].items():
        monkeypatch.setattr(tfr, name, value)
    tfr._card_plan.cache_clear()
    try:
        got = tfr.run_rollout_kernel(*args, actions, cfg, transition, ctl=ctl_in)
        used = tfr.last_rollout_plan
    finally:
        tfr._card_plan.cache_clear()
    want = tfr.plain_rollout(*args, actions, cfg, transition, ctl=ctl_in)
    assert (used.cell_bits, used.threads_per_lane) == {"cells16_t1": (16, 1), "cells16_t4": (16, 4),
                                                      "generic_int32": (32, 1)}[plan]
    for name, g, w in zip(("words", "regs", "rsum", "episodes", "checksum", "ctl"), got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    assert int(want[3].sum()) > 0


# One id of each family this slice adds; each runs at 9x9 and 19x19.
NEW_FAMILY_IDS = ("MiniGrid-LavaGapS7-v0", "MiniGrid-FourRooms-v0", "MiniGrid-LavaCrossingS9N1-v0",
                  "MiniGrid-SimpleCrossingS11N5-v0", "MiniGrid-LockedRoom-v0", "MiniGrid-Playground-v0")


def family_case(env_id, size, b, dev, seed=0):
    """The family's own layouts at `size` x `size` (`max_steps` cut to 12 so
    lanes end episodes, Crossing's rivers cut to what the size holds):
    `(cfg, [words, regs, tmpl_words, tmpl_regs])` of `b` lanes on `dev`,
    cached mode's carry."""
    env = make(env_id)
    cfg = env.config
    crossings = cfg.num_crossings and min(cfg.num_crossings, 2 * len(range(2, size - 2, 2)))
    cfg = dataclasses.replace(cfg, width=size, height=size, max_steps=12, num_crossings=crossings)
    env = dataclasses.replace(env, config=cfg)
    carry = tfr.packed_init(env, env.reset_batch(key(seed, device=dev), b)[0], "cached")
    return cfg, [carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs]


@pytest.mark.gpu
@pytest.mark.parametrize("size", [9, 19])
@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("env_id", NEW_FAMILY_IDS)
def test_cuda_rollout_kernel_on_the_new_families_matches_plain(env_id, ctl, size):
    """LavaGap, FourRooms, both Crossings, LockedRoom and Playground on their
    own layouts (lava, locked doors, objects; occlusion on), a ragged batch
    (2,048 + 32 lanes), with and without commit rows, byte for byte."""
    dev = _cuda()
    b, t = 2048 + 32, 24
    cfg, args = family_case(env_id, size, b, dev, seed=size)
    assert tfr.rollout_cell_bits(cfg) == 16
    rng = np.random.default_rng(size + ctl)
    actions = torch.from_numpy(rng.integers(0, 7, (t, b)).astype(np.int32)).to(dev)
    ctl_in = None
    if ctl:
        rows = np.stack([rng.integers(0, 2, b), rng.integers(0, t + 1, b), rng.random(b) < 0.1]).astype(np.int32)
        rows[:, : b // 2] = 0
        ctl_in = torch.from_numpy(rows).to(dev)
    before = tfr.rollout_kernel_launches
    got = tfr.run_rollout_kernel(*args, actions, cfg, ctl=ctl_in)
    want = tfr.plain_rollout(*args, actions, cfg, ctl=ctl_in)
    torch.cuda.synchronize()
    assert tfr.rollout_kernel_launches == before + 1
    for name, g, w in zip(("words", "regs", "rsum", "episodes", "checksum", "ctl"), got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    assert int(want[3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cached", "regen"])
def test_cuda_rollout_kernel_on_the_obstructed_script_matches_plain(mode):
    """`testing.obstructed_script_case` (a key boxed, toggled out or
    carried in its box; the locked door; the blue ball) in 64 copies: the
    kernel under the script's actions against the plain twin, byte for
    byte, and the per-env step's rewards and final states (cached: the
    template is the doctored state itself)."""
    from minigrid_tpu_torch.core.rollout import build_rollout
    from minigrid_tpu_torch.testing import OBSTRUCTED_ID, obstructed_script_case
    from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    dev = _cuda()
    env = make(OBSTRUCTED_ID)
    s, script = obstructed_script_case(copies=64)
    states = state_from_numpy(s, device=dev)
    carry = tfr.packed_init(env, states, mode)
    actions = torch.from_numpy(script).to(dev)
    args = [carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs]
    before = tfr.rollout_kernel_launches
    got = tfr.run_rollout_kernel(*args, actions, env.config, env.transition)
    want = tfr.plain_rollout(*args, actions, env.config, env.transition)
    torch.cuda.synchronize()
    assert tfr.rollout_kernel_launches == before + 1
    for name, g, w in zip(("words", "regs", "rsum", "episodes", "checksum"), got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    assert int(want[3].sum()) == 64 and float(want[2].sum()) > 0
    if mode == "cached":
        steps = iter(actions)
        final, metrics = build_rollout(env, len(script), policy=lambda k, obs: next(steps), autoreset_mode=mode)(
            key(0, device=dev), states)
        packed = tfr.packed_finish(env, tfr.PackedCarry(got[0], got[1], carry.tmpl_words, carry.tmpl_regs, carry.rng))
        a, b = state_to_numpy(final), state_to_numpy(packed)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert int(metrics.episodes) == 64


_MISFIT = """
import sys
import numpy as np
import torch
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.testing import random_packed_case

cfg = EnvConfig(family="empty", width=8, height=8, max_steps=256, see_through_walls=False)
case = random_packed_case(3, 8, 8, 256, cfg.max_steps)
case["words"][5, 7] = 1 << 20
args = [torch.from_numpy(case[k]).to("cuda") for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
fr.run_rollout_kernel(*args, torch.zeros((4, 256), dtype=torch.int32, device="cuda"), cfg)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.gpu
def test_cuda_rollout_kernel_traps_on_a_word_that_does_not_fit_16_bits():
    """A word that does not fit a 16-bit cell traps the launch, and the
    next synchronization raises (in a process of its own: a trap leaves
    the CUDA context unusable)."""
    _cuda()
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run([sys.executable, "-c", _MISFIT], capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[2])
    assert res.returncode == 0 and "raised:" in res.stdout, res.stdout + res.stderr
