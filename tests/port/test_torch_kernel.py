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
from minigrid_tpu_torch.testing import random_packed_case

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
    carry = tfr.packed_init(env, env.reset_batch(key(0, device=dev), 8192), "regen")
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
