"""Carry state across the framework boundary as numpy arrays.

`EnvState` and `PackedCarry` to and from dictionaries of numpy arrays
with the JAX package's leaf names and dtypes. The rng leaf crosses as
`(B, 2)` uint32 bit patterns (the JAX key layout); in the port it is
int64 holding the same values. A JAX state or carry becomes such a
dictionary with `{name: np.asarray(leaf)}` over its fields.

A JAX `TrainState` crosses as its params tree (`models.policy.
load_flax_params`, `ActorCritic.from_flax`) and the `(count, mu, nu)` of
its optimizer state (`opt_state_from_optax`, `opt_state_to_numpy`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from minigrid_tpu_torch.core.prng import default_device
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.ops.fused_rollout import PackedCarry
from minigrid_tpu_torch.parallel.train import AdamState

STATE_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux")
CARRY_FIELDS = PackedCarry._fields

_STATE_DTYPES = {
    "grid": np.uint8,
    "agent_pos": np.int32,
    "agent_dir": np.int32,
    "carrying": np.uint8,
    "step_count": np.int32,
    "mission": np.int32,
    "aux": np.int32,
}


def _rng_in(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.uint32:
        raise TypeError(f"rng leaf must be uint32 key words, got {a.dtype}")
    return a.astype(np.int64)


def _rng_out(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> EnvState:
    """A batched `EnvState` on `device` (default: the card) from numpy leaves."""
    device = default_device(device)
    leaves = {}
    for name in STATE_FIELDS:
        a = _rng_in(arrays[name]) if name == "rng" else np.asarray(arrays[name], _STATE_DTYPES[name])
        leaves[name] = torch.from_numpy(np.array(a)).to(device)  # a writable copy
    return EnvState(**leaves)


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """An `EnvState`'s leaves as numpy arrays in the JAX package's dtypes."""
    return {
        name: _rng_out(getattr(state, name)) if name == "rng" else getattr(state, name).cpu().numpy()
        for name in STATE_FIELDS
    }


def carry_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> PackedCarry:
    """A `PackedCarry` on `device` (default: the card) from numpy leaves
    (int32 words and registers, uint32 rng)."""
    device = default_device(device)
    leaves = {
        name: torch.from_numpy(
            _rng_in(arrays[name]) if name == "rng" else np.array(arrays[name], np.int32)
        ).to(device)
        for name in CARRY_FIELDS
    }
    return PackedCarry(**leaves)


def carry_to_numpy(carry: PackedCarry) -> Dict[str, np.ndarray]:
    """A `PackedCarry`'s leaves as numpy arrays (rng as uint32)."""
    return {
        name: _rng_out(getattr(carry, name)) if name == "rng" else getattr(carry, name).cpu().numpy()
        for name in CARRY_FIELDS
    }


def opt_state_from_optax(opt_state, device=None) -> AdamState:
    """The port's `AdamState` on `device` (default: the card) from the
    JAX package's `TrainState.opt_state`, `(EmptyState(),
    (ScaleByAdamState(count, mu, nu), EmptyState()))` of
    `optax.flatten(chain(clip_by_global_norm, adam))`, its leaves numpy
    arrays (or anything `np.asarray` takes)."""
    device = default_device(device)
    adam = opt_state[1][0]
    return AdamState(
        count=torch.from_numpy(np.array(adam.count, np.int32)).to(device),
        mu=torch.from_numpy(np.array(adam.mu, np.float32)).to(device),
        nu=torch.from_numpy(np.array(adam.nu, np.float32)).to(device),
    )


def opt_state_to_numpy(state: AdamState) -> Dict[str, np.ndarray]:
    """`{"count": () int32, "mu": (N,) f32, "nu": (N,) f32}`: the leaves
    of optax's `ScaleByAdamState`."""
    return {name: getattr(state, name).cpu().numpy() for name in AdamState._fields}


def grads_to_flax_numpy(tree) -> Dict:
    """A flax-layout params or grads tree of tensors (`{"params": {layer:
    {"kernel", "bias"}}}`) -> the same tree of numpy arrays."""
    return {"params": {n: {k: v.detach().cpu().numpy() for k, v in layer.items()}
                       for n, layer in tree["params"].items()}}
