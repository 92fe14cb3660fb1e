"""The port's entry points run on the card unless the caller asks for the
CPU, and no module of the port (nor `chip_smoke.py`) imports JAX, flax or
the JAX package. This file imports no JAX."""

import ast
import os

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


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
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
    for module in ("envs/dynamicobstacles.py", "envs/memory.py", "envs/unlock.py", "envs/unlockpickup.py",
                   "envs/roomgrid.py", "ops/packed_hooks.py"):
        assert os.path.join(REPO, "minigrid_tpu_torch", module) in paths, module
    bad = {
        os.path.relpath(p, REPO): sorted(set(_imported_packages(p)) & FORBIDDEN) for p in paths
    }
    assert not {p: names for p, names in bad.items() if names}
    # The walk sees the port's own imports (so it would see a forbidden one).
    assert "minigrid_tpu_torch" in set(_imported_packages(os.path.join(REPO, "chip_smoke.py")))
