"""The port's entry points run on the card unless the caller asks for the
CPU, and no module of the port (nor `chip_smoke.py`) imports JAX, flax or
the JAX package. This file imports no JAX."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.parallel.train import AdamState, init_train_state
from minigrid_tpu_torch.utils.convert import carry_from_numpy, opt_state_from_optax, state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "minigrid_tpu"}


def test_key_defaults_to_the_card():
    if torch.cuda.is_available():
        assert key(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            key(0)
    assert key(0, device="cpu").device.type == "cpu"


def test_numpy_conversions_default_to_the_card():
    leaves = {"words": np.zeros((4, 2), np.int32), "rng": np.zeros((2, 2), np.uint32)}
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(leaves)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry_from_numpy(leaves)


def test_train_state_defaults_to_the_card():
    env = make("MiniGrid-Empty-5x5-v0")
    adam = AdamState(np.int32(0), np.zeros(4, np.float32), np.zeros(4, np.float32))
    optax_like = ((), (adam, ()))
    if torch.cuda.is_available():
        ts = init_train_state(env)
        assert next(ts.params.parameters()).device.type == "cuda"
        assert {x.device.type for x in ts.opt_state} == {"cuda"}
        assert opt_state_from_optax(optax_like).mu.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(env)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt_state_from_optax(optax_like)
    ts = init_train_state(env, device="cpu")
    assert next(ts.params.parameters()).device.type == "cpu"
    assert {x.device.type for x in ts.opt_state} == {"cpu"}
    assert ts.opt_state.mu.shape == (318_984,) and int(ts.opt_state.count) == 0


MIXED_IDS = ("MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-FourRooms-v0")


def _mixed_outputs(device, monkeypatch):
    """One call of each mixed surface on member carries on `device`, with
    the port's default device made to raise: nothing inside may fall back
    to it. Returns every output tensor."""
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.ops.fused_rollout import packed_init
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.testing import dyadic_flax_params

    carries = tuple(packed_init(make(e), make(e).reset_batch(key(i, device=device), 32)[0], "regen")
                    for i, e in enumerate(MIXED_IDS))

    def no_default(device=None):
        if device is None:
            raise AssertionError("a mixed surface asked for the default device")
        return torch.device(device)

    monkeypatch.setattr(prng, "default_device", no_default)
    # Built with no device in sight: the builders make no tensor.
    rollout = mixed.build_packed_mixed_rollout(MIXED_IDS, 8, mode="regen", as_carry=True)
    policy = mixed.build_mixed_policy_eval(MIXED_IDS, [dyadic_flax_params(0)] * 2, 8, mode="regen")
    out = []
    for step in (rollout, policy):
        finals, metrics = step(key(5, device=device), carries)
        out += [t for carry in finals for t in carry] + list(metrics)
    return out


def test_mixed_surfaces_follow_their_inputs_onto_the_cpu(monkeypatch):
    """The mixed builders run on the card unless the caller's key and
    carries are on the CPU, as here: every output lies on the CPU."""
    outputs = _mixed_outputs(torch.device("cpu"), monkeypatch)
    assert len(outputs) == 2 * (2 * 5 + 5) and {t.device.type for t in outputs} == {"cpu"}


@pytest.mark.gpu
def test_mixed_surfaces_stay_on_the_card(monkeypatch):
    """On card carries and key, no output (nor any tensor the metrics sum)
    lies on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    outputs = _mixed_outputs(torch.device("cuda"), monkeypatch)
    assert {t.device.type for t in outputs} == {"cuda"}


ENGINE_IDS = ("MiniGrid-ObstructedMaze-1Dlhb-v0", "MiniGrid-DoorKey-5x5-v0")


def _engine_outputs(device, monkeypatch):
    """`make`, `reset_batch`, `step`, `build_rollout` (both modes),
    `MixedEnv.create`, its `reset_batch` and `build_mixed_rollout` from a
    key on `device`, with the port's default device made to raise: nothing
    inside may fall back to it. Returns every output tensor."""
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.core.rollout import build_rollout
    from minigrid_tpu_torch.parallel import mixed

    k0, k1 = key(0, device=device), key(1, device=device)

    def no_default(device=None):
        if device is None:
            raise AssertionError("the per-env engine asked for the default device")
        return torch.device(device)

    monkeypatch.setattr(prng, "default_device", no_default)
    out = []
    for env_id in ENGINE_IDS:
        env = make(env_id)
        states, obs = env.reset_batch(k0, 8)
        out += list(vars(states).values()) + list(obs.values())
        out += [t for t in env.step(states, torch.full((8,), 2, dtype=torch.int32, device=device))[2:]]
        for mode in ("regen", "cached"):
            final, metrics = build_rollout(env, 4, autoreset_mode=mode)(k1, states)
            out += list(vars(final).values()) + list(metrics)
    menv = mixed.MixedEnv.create(MIXED_IDS)
    states, obs = menv.reset_batch(k0, torch.tensor([0, 1, 1, 0], device=device))
    final, metrics = mixed.build_mixed_rollout(menv, 4)(k1, states)
    return out + list(vars(states).values()) + [obs["image"]] + list(vars(final).values()) + list(metrics)


def test_engine_entry_points_default_to_the_card(monkeypatch):
    """The per-env engine makes its tensors where its key lies: on the CPU
    when the caller names it (as here), on the card by default (`key`),
    which raises without one."""
    outputs = _engine_outputs(torch.device("cpu"), monkeypatch)
    assert len(outputs) > 100 and {t.device.type for t in outputs} == {"cpu"}
    monkeypatch.undo()
    env = make(ENGINE_IDS[0])
    if torch.cuda.is_available():
        assert env.reset_batch(key(0), 4)[0].grid.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            env.reset_batch(key(0), 4)


@pytest.mark.gpu
def test_engine_entry_points_stay_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    outputs = _engine_outputs(torch.device("cuda"), monkeypatch)
    assert {t.device.type for t in outputs} == {"cuda"}


def test_mesh_entry_points_default_to_the_card():
    """A mesh, a process group and the dry run take every visible card by
    default and raise without one: CPU shards are asked for by name."""
    from minigrid_tpu_torch.parallel import distributed
    from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip
    from minigrid_tpu_torch.parallel.sharding import make_env_mesh

    if torch.cuda.is_available():
        assert {d.type for d in make_env_mesh().shard_devices} == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_env_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA devices needed"):
        dryrun_multichip(2)
    distributed.initialize()  # one process: nothing to join
    assert make_env_mesh(["cpu"] * 2).shard_devices == (torch.device("cpu"),) * 2


def _sharded_outputs(device, monkeypatch):
    """One call of each sharded surface and train step over two shards on
    `device`, with the port's default device made to raise. Returns every
    output tensor."""
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.ops.fused_rollout import packed_init
    from minigrid_tpu_torch.parallel import packed, sharding, train
    from minigrid_tpu_torch.testing import dyadic_flax_params

    env = make("MiniGrid-Empty-5x5-v0")
    mesh = sharding.make_env_mesh([device] * 2)
    states = sharding.shard_states(env.reset_batch(key(0, device=device), 128)[0], mesh)
    carries = tuple(packed_init(env, s, "regen") for s in states)
    ts = train.init_train_state(env, device=device, mesh=mesh)

    def no_default(device=None):
        if device is None:
            raise AssertionError("a sharded surface asked for the default device")
        return torch.device(device)

    monkeypatch.setattr(prng, "default_device", no_default)
    k = key(1, device=device)
    out = []
    for step, value in ((packed.build_sharded_rollout(env, 4, mesh, as_carry=True), carries),
                        (packed.build_sharded_policy_eval(env, dyadic_flax_params(0), 4, mesh, mode="regen",
                                                          as_carry=True), carries)):
        finals, metrics = step(k, value)
        out += [t for c in finals for t in c] + list(metrics)
    for step, value in ((train.build_train_step(env, 4, mesh=mesh), states),
                        (train.build_packed_train_step(env, 4, mesh=mesh, as_carry=True), carries),
                        (train.build_fused_train_step(env, 4, mode="regen", mesh=mesh), carries)):
        new_ts, finals, metrics = step(ts, value, k)
        out += list(new_ts.params.parameters()) + list(new_ts.opt_state) + list(metrics.values())
        out += [t for f in finals for t in (f if isinstance(f, tuple) else vars(f).values())]
    return out


def test_sharded_surfaces_follow_their_inputs_onto_the_cpu(monkeypatch):
    outputs = _sharded_outputs("cpu", monkeypatch)
    assert len(outputs) > 50 and {t.device.type for t in outputs} == {"cpu"}


@pytest.mark.gpu
def test_sharded_surfaces_stay_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    outputs = _sharded_outputs("cuda:0", monkeypatch)
    assert {t.device.type for t in outputs} == {"cuda"}


# The port's own scripts in the root `tools/` (the others there are the JAX
# package's).
PORT_ROOT_TOOLS = ("profile_step_torch.py", "b1_cycle_split.py", "b1_plan_sweep.py", "gen_kernel_sweep.py",
                   "gen_work_model.py", "mesh_host_threads.py", "autoreset_designs.py")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")] + [os.path.join(REPO, "tools", f) for f in PORT_ROOT_TOOLS]
    for root, _, files in os.walk(os.path.join(REPO, "minigrid_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_packages(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_module_imports_jax_flax_or_the_jax_package():
    paths = _port_sources()
    assert len(paths) >= 20, paths
    assert all(os.path.isfile(p) for p in paths), [p for p in paths if not os.path.isfile(p)]
    for module in ("envs/dynamicobstacles.py", "envs/memory.py", "envs/unlock.py", "envs/unlockpickup.py",
                   "envs/roomgrid.py", "ops/packed_hooks.py", "envs/lavagap.py", "envs/fourrooms.py",
                   "envs/crossing.py", "envs/lockedroom.py", "envs/playground.py", "parallel/mixed.py",
                   "envs/obstructedmaze.py", "core/grid.py", "core/view.py", "core/vision.py", "core/obs.py",
                   "core/step.py", "core/autoreset.py", "core/rollout.py", "envs/base.py", "parallel/sharding.py",
                   "parallel/packed.py", "parallel/train.py", "parallel/distributed.py", "parallel/dryrun.py",
                   "render/__init__.py", "render/draw.py", "render/atlas.py", "render/render.py",
                   "wrappers/__init__.py", "wrappers/wrappers.py", "utils/ascii.py", "utils/checkpoint.py",
                   "compat/__init__.py", "compat/seeding.py", "compat/exact.py", "compat/host_env.py",
                   "compat/gym_env.py", "compat/host_wrappers.py", "tools/profile.py", "tools/window.py",
                   "tools/benchmark.py", "tools/run_tests.py", "tools/manual_control.py"):
        assert os.path.join(REPO, "minigrid_tpu_torch", module) in paths, module
    bad = {
        os.path.relpath(p, REPO): sorted(set(_imported_packages(p)) & FORBIDDEN) for p in paths
    }
    assert not {p: names for p, names in bad.items() if names}
    # The walk sees the port's own imports (so it would see a forbidden one).
    assert "minigrid_tpu_torch" in set(_imported_packages(os.path.join(REPO, "chip_smoke.py")))


def test_importing_the_port_loads_no_gymnasium_matplotlib_or_orbax():
    """A fresh process: `import minigrid_tpu_torch` (and the compat layer's
    replayer, which the card's smoke test runs) leaves the three packages
    the card's machine lacks unloaded."""
    code = ("import sys, minigrid_tpu_torch, minigrid_tpu_torch.compat.exact, minigrid_tpu_torch.compat.host_env, "
            "minigrid_tpu_torch.render, minigrid_tpu_torch.wrappers, minigrid_tpu_torch.utils.checkpoint, "
            "minigrid_tpu_torch.tools.profile, minigrid_tpu_torch.tools.window, minigrid_tpu_torch.tools.benchmark, "
            "minigrid_tpu_torch.tools.run_tests, minigrid_tpu_torch.tools.manual_control; "
            "loaded = {'gymnasium', 'matplotlib', 'orbax', 'jax'} & set(sys.modules); assert not loaded, loaded")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def _surface_outputs(device, monkeypatch):
    """The surfaces of the compat layer, the wrappers, the renderer and the
    checkpoint on `device`, with the port's default device made to raise:
    nothing inside may fall back to it. Returns every output tensor."""
    import tempfile

    from minigrid_tpu_torch import wrappers
    from minigrid_tpu_torch.compat.exact import CompatEnv, dynobst_step, state_to_device
    from minigrid_tpu_torch.compat.host_env import HostEnv
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.render.render import render_state
    from minigrid_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    def no_default(device=None):
        if device is None:
            raise AssertionError("a surface asked for the default device")
        return torch.device(device)

    monkeypatch.setattr(prng, "default_device", no_default)
    out = []
    env = make("MiniGrid-Dynamic-Obstacles-5x5-v0")
    ce = CompatEnv(env.env_id, seed=3)
    state = state_to_device(ce.reset(), env.config, device=device)
    state, obs, r, te, tr = dynobst_step(ce, env, state, 2)
    out += list(vars(state).values()) + list(obs.values()) + [r, te, tr]
    host = HostEnv(make("MiniGrid-DoorKey-5x5-v0"), device=device)
    host.reset(seed=1)
    host.step(2)
    host.hash(), str(host), host.render(tile_size=8)
    out += list(vars(host.state).values())
    out.append(render_state(state, env.config, 8))
    for wenv in (wrappers.full_obs(env), wrappers.one_hot_partial_obs(env), wrappers.rgb_img_partial_obs(env)):
        out.append(wenv.observe(state, env.config)["image"])
    cenv = wrappers.action_bonus(env)
    counts = cenv.init_counts(1, device=device)
    out += [t for t in cenv.step(counts, state, torch.tensor([1], device=device))[:1]]
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(os.path.join(tmp, "s.pt"), state)
        out += list(vars(load_pytree(os.path.join(tmp, "s.pt"), state, device=device)).values())
    return out


def test_surfaces_follow_their_device_onto_the_cpu(monkeypatch):
    outputs = _surface_outputs(torch.device("cpu"), monkeypatch)
    assert len(outputs) > 30 and {t.device.type for t in outputs} == {"cpu"}


@pytest.mark.gpu
def test_surfaces_stay_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    outputs = _surface_outputs(torch.device("cuda"), monkeypatch)
    assert {t.device.type for t in outputs} == {"cuda"}


def test_surface_entry_points_default_to_the_card(tmp_path):
    """`gym_make`, `state_to_device`, `load_pytree`, the count tables and
    the profiler's trace run on the card by default and raise without
    one."""
    from minigrid_tpu_torch import wrappers
    from minigrid_tpu_torch.compat.exact import CompatEnv, state_to_device
    from minigrid_tpu_torch.compat.gym_env import gym_make
    from minigrid_tpu_torch.tools import profile
    from minigrid_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    env = make("MiniGrid-Empty-5x5-v0")
    layout = CompatEnv(env.env_id, seed=0).reset()
    path = str(tmp_path / "t.pt")
    save_pytree(path, [torch.zeros(2)])
    calls = (lambda: gym_make(env.env_id).device, lambda: state_to_device(layout, env.config).grid.device,
             lambda: load_pytree(path, [torch.zeros(2)])[0].device,
             lambda: wrappers.state_bonus(env).init_counts(2).device)
    if torch.cuda.is_available():
        assert {c().type for c in calls} == {"cuda"}
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile.trace(str(tmp_path)):
            pass
    assert gym_make(env.env_id, device="cpu").device.type == "cpu"
