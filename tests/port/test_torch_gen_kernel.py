"""The connect loop (`ops/gen_kernel.py`): its plain version against the
JAX package's `connect_plan_batched`, and on a card the CUDA kernel
against the plain version.

The JAX reference runs its Pallas kernel `_connect_kernel` in interpret
mode (`backend="kernel"`), as the JAX package's own tests run it off the
TPU; they hold it byte-exact against `backend="xla"`
(tests/test_gen_kernel.py), whose 16-draw unrolled loop takes 17-42 s to
compile on the CPU. Inputs are built as there: random start rooms,
locked rooms and prior doors from a numpy seed, so some lanes can never
connect and run to `max_itrs`.

JAX is imported only by the tests that compare with it, so the `gpu`
tests also run on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" tests/port/test_torch_gen_kernel.py -q
"""

import functools

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.ops import gen_kernel as tgk
from minigrid_tpu_torch.ops.packing import key_rows

B = 64
GEOMETRIES = {"S6R3": "MiniGrid-KeyCorridorS6R3-v0", "S3R1": "MiniGrid-KeyCorridorS3R1-v0"}


def _inputs(rows, cols, b, seed):
    """(keys (B, 2) uint32, start_i, start_j, locked (B, R, C), prior doors
    (B, R, C, 4)) from numpy."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2**32, size=(b, 2), dtype=np.uint64).astype(np.uint32)
    si = rng.randint(0, cols, b).astype(np.int32)
    sj = rng.randint(0, rows, b).astype(np.int32)
    locked = rng.rand(b, rows, cols) < 0.1
    hd0 = rng.rand(b, rows, cols, 4) < 0.15
    return keys, si, sj, locked, hd0


@functools.lru_cache(maxsize=None)
def _jax_connect(env_id, max_itrs, seed):
    jax = pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.ops.gen_kernel import connect_plan_batched

    cfg = minigrid_tpu.make(env_id).config
    args = _inputs(cfg.num_rows, cfg.num_cols, B, seed)
    fn = jax.jit(lambda *a: connect_plan_batched(a[0], cfg, *a[1:], max_itrs=max_itrs, backend="kernel"))
    return tuple(np.asarray(x) for x in fn(*args))


@pytest.mark.parametrize("geometry,max_itrs", [("S6R3", 5000), ("S3R1", 5000), ("S3R1", 3)])
def test_plain_connect_plan_matches_jax(geometry, max_itrs):
    env_id = GEOMETRIES[geometry]
    want_doors, want_colors = _jax_connect(env_id, max_itrs, 3)
    cfg = make(env_id).config
    keys, si, sj, locked, hd0 = (torch.from_numpy(np.asarray(x)) for x in _inputs(cfg.num_rows, cfg.num_cols, B, 3))
    before = tgk.connect_kernel_launches
    doors, colors = tgk.connect_plan_batched(keys.to(torch.int64), cfg, si, sj, locked, hd0, max_itrs=max_itrs)
    assert tgk.connect_kernel_launches == before  # CPU tensors: the plain version
    assert doors.dtype == torch.bool and colors.dtype == torch.uint8
    np.testing.assert_array_equal(doors.numpy(), want_doors)
    np.testing.assert_array_equal(colors.numpy(), want_colors)
    if max_itrs == 3:  # the unconverged exit, after some doors were added
        assert not np.array_equal(want_doors, hd0.numpy())


def test_port_colour_order_is_the_jax_packages():
    pytest.importorskip("jax")
    from minigrid_tpu.envs import roomgrid as jrg
    from minigrid_tpu_torch.envs import roomgrid as trg

    assert trg.COLOR_ORDER == tuple(int(c) for c in jrg.COLOR_ORDER)


def _plain_args(rows, cols, b, seed, device):
    keys, si, sj, locked, hd0 = _inputs(rows, cols, b, seed)
    packed = tgk._pack_bits
    t = torch.from_numpy
    return (
        key_rows(t(keys.astype(np.int64))).to(device),
        t(si)[None].to(device),
        t(sj)[None].to(device),
        packed(t(locked).reshape(b, -1)).to(device),
        torch.cat([packed(t(hd0[..., d]).reshape(b, -1)) for d in range(4)]).to(device),
    )


def test_plain_version_counts_draws_and_stops_stuck_lanes_at_max_itrs():
    rows, cols = 3, 3
    args = _plain_args(rows, cols, 256, 4, "cpu")
    hd, colors, draws = tgk.plain_connect_plan(*args, rows, cols, 40)
    assert hd.dtype == colors.dtype == draws.dtype == torch.int32
    assert tuple(draws.shape) == (1, 256) and int(draws.min()) >= 0 and int(draws.max()) == 40
    connected = tgk._connected(hd.long(), 1 << (args[2][0].long() * cols + args[1][0].long()), rows, cols)
    assert bool((connected | (draws[0] == 40)).all())


def test_wrapper_raises_off_cpu_and_for_too_many_rooms():
    args = [x.to("meta") for x in _plain_args(3, 3, 32, 5, "cpu")]
    with pytest.raises(ValueError, match="CUDA"):
        tgk.run_connect_kernel(*args, 3, 3, 10)
    with pytest.raises(ValueError, match="room masks"):
        tgk.run_connect_kernel(*args, 5, 7, 10)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,max_itrs", [(4096, 5000), (4096 + 77, 5000), (4096 + 77, 7)])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_cuda_connect_kernel_matches_plain_version(geometry, b, max_itrs):
    dev = _cuda()
    cfg = make(GEOMETRIES[geometry]).config
    args = _plain_args(cfg.num_rows, cfg.num_cols, b, b + max_itrs, dev)
    before = tgk.connect_kernel_launches
    got = tgk.run_connect_kernel(*args, cfg.num_rows, cfg.num_cols, max_itrs)
    torch.cuda.synchronize()
    assert tgk.connect_kernel_launches == before + 1
    want = tgk.plain_connect_plan(*args, cfg.num_rows, cfg.num_cols, max_itrs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_keycorridor_layouts_match_the_plain_generator():
    """The S6R3 generator's own connect inputs, through the kernel (CUDA
    keys) and the plain version (CPU keys)."""
    dev = _cuda()
    from minigrid_tpu_torch.envs.keycorridor import generate_packed

    env = make("MiniGrid-KeyCorridorS6R3-v0")
    keys = torch.from_numpy(np.random.default_rng(6).integers(0, 2**32, (2048, 2), dtype=np.uint64).astype(np.int64))
    before = tgk.connect_kernel_launches
    got = generate_packed(keys.to(dev), env.config)
    assert tgk.connect_kernel_launches == before + 1
    want = generate_packed(keys, env.config)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _connect_case(case):
    """(args, max_itrs) of a connect-kernel case on the CPU: numpy-random
    inputs on S6R3's 3x3 room grid at 1, 33 and 4,096 + 77 lanes; lanes
    already connected (every slot with a neighbour has a door: 0 draws),
    and lanes that can never connect (every room locked, and a few doors)
    at max_itrs 5000 and 7, each beside random lanes; and a 5 x 6 room
    grid, the most rooms the masks hold."""
    b, rows, cols, max_itrs = {"b1": (1, 3, 3, 5000), "b33": (33, 3, 3, 5000), "ragged": (4096 + 77, 3, 3, 5000),
                               "connected": (512, 3, 3, 5000), "stuck_5000": (512, 3, 3, 5000),
                               "stuck_7": (512, 3, 3, 7), "grid_5x6": (1024, 5, 6, 5000)}[case]
    args = list(_plain_args(rows, cols, b, b + rows * cols + max_itrs, "cpu"))
    if case == "connected":
        right, left = tgk._edges(rows, cols)
        full = (1 << rows * cols) - 1
        bottom = sum(1 << ((rows - 1) * cols + i) for i in range(cols))
        top = sum(1 << i for i in range(cols))
        every = torch.tensor([full & ~right, full & ~bottom, full & ~left, full & ~top], dtype=torch.int32)
        args[4][:, ::2] = every[:, None]
    elif case.startswith("stuck"):
        args[3][0, ::2] = (1 << rows * cols) - 1
    return args, rows, cols, max_itrs


CONNECT_CASES = ("b1", "b33", "ragged", "connected", "stuck_5000", "stuck_7", "grid_5x6")


def test_connect_cases_hold_what_they_name():
    """The special lanes of `_connect_case`: connected ones draw nothing,
    stuck ones run to max_itrs and keep their doors, and the random lanes
    beside them add doors (the plain version, on the CPU)."""
    for case in ("connected", "stuck_5000", "stuck_7"):
        args, rows, cols, max_itrs = _connect_case(case)
        hd, _, draws = tgk.plain_connect_plan(*args, rows, cols, max_itrs)
        draws = draws[0]
        if case == "connected":
            assert bool((draws[::2] == 0).all()) and bool((draws[1::2] > 0).all())
        else:
            assert bool((draws[::2] == max_itrs).all()) and torch.equal(hd[:, ::2], args[4][:, ::2])
            assert not torch.equal(hd[:, 1::2], args[4][:, 1::2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONNECT_CASES)
def test_cuda_connect_kernel_plans_match_plain_version(case):
    """The kernel on each case, byte for byte against the plain version;
    two launches agree."""
    dev = _cuda()
    args, rows, cols, max_itrs = _connect_case(case)
    args = [x.to(dev) for x in args]
    got = tgk.run_connect_kernel(*args, rows, cols, max_itrs)
    again = tgk.run_connect_kernel(*args, rows, cols, max_itrs)
    want = tgk.plain_connect_plan(*args, rows, cols, max_itrs)
    for name, g, a, w in zip(("doors", "colors", "draws"), got, again, want):
        assert torch.equal(g, w), name
        assert torch.equal(a, g), name
