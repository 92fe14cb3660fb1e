"""Device meshes and sharded values (counterpart of
`minigrid_tpu/parallel/sharding.py`).

The JAX package runs one program over a mesh of devices and lets GSPMD
split the env batch over the mesh's `"env"` axis. The port keeps that
model inside one process: a `Mesh` is an `(n_env, model_parallel)` array
of `torch.device`, and a *sharded value* is a tuple of per-shard values,
the batch's lane slices in shard order, each on its shard's device (the
first device of its row of the mesh). The build functions of `parallel/packed.py`,
`parallel/train.py` and `parallel/mixed.py` take such tuples and run each
shard on its device.

A shard is an index on the env axis, not a device: the same device may
appear more than once. That is how a CPU test builds the 8-shard mesh the
JAX package's tests build from 8 virtual CPU devices, and how one card
holds two shards. It adds nothing a user of the JAX package could not do
with a mesh of its devices.

Nothing shards over the model axis, as in the JAX package, whose train
steps replicate the parameters: `replicated` gives one copy on each
distinct device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from minigrid_tpu_torch.core.state import EnvState

ENV_AXIS = "env"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An `(n_env, model_parallel)` array of devices, axes `("env",
    "model")`. `shard_offset` is the global index of this process's first
    env shard and `global_shards` the env shards of the whole job
    (`parallel/distributed.py::global_env_mesh`); in one process they are
    0 and `n_env`."""

    devices: np.ndarray
    shard_offset: int = 0
    global_shards: Optional[int] = None

    axis_names = (ENV_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    @property
    def n_env(self) -> int:
        """This process's env shards."""
        return self.devices.shape[0]

    @property
    def n_global(self) -> int:
        """The job's env shards."""
        return self.n_env if self.global_shards is None else self.global_shards

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """Each env shard's device: the first of its row."""
        return tuple(self.devices[:, 0])

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.shard_devices))


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (`cuda` is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_env_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> Mesh:
    """A `("env", "model")` mesh over `devices` (default: every visible
    CUDA device; raises when there is none, as the port's entry points do).
    `devices` may name one device more than once: each entry is a shard."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to build a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices do not split into rows of model_parallel={model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel))


def _bounds(b: int, mesh: Mesh):
    """`(lo, hi)` lane bounds of each shard of a `b`-lane batch."""
    if b % mesh.n_env:
        raise ValueError(f"a batch of {b} lanes does not split over {mesh.n_env} env shards")
    s = b // mesh.n_env
    return [(i * s, (i + 1) * s) for i in range(mesh.n_env)]


def shard_states(states: EnvState, mesh: Mesh) -> Tuple[EnvState, ...]:
    """A batched `EnvState` split along its batch axis over the env shards:
    one `EnvState` per shard, on the shard's device."""
    b = states.step_count.shape[0]
    return tuple(
        EnvState(**{f.name: getattr(states, f.name)[lo:hi].to(dev).contiguous() for f in dataclasses.fields(states)})
        for (lo, hi), dev in zip(_bounds(b, mesh), mesh.shard_devices)
    )


def gather_states(shards: Sequence[EnvState], device=None) -> EnvState:
    """The shards of `shard_states` joined in shard order, on `device`
    (default: the first shard's)."""
    device = shards[0].step_count.device if device is None else torch.device(device)
    return EnvState(**{
        f.name: torch.cat([getattr(s, f.name).to(device) for s in shards])
        for f in dataclasses.fields(shards[0])
    })


def _to(value, device: torch.device):
    """`value` with every tensor (and module) of it on `device`: the value
    itself where nothing moves."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, nn.Module):
        here = {p.device for p in value.parameters()} | {b.device for b in value.buffers()}
        return value if here <= {device} else copy.deepcopy(value).to(device)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_to(v, device) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_to(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to(v, device) for k, v in value.items()}
    return value


def replicated(value, mesh: Mesh) -> tuple:
    """`value` (a tensor, an `nn.Module`, or tuples, lists and dicts of
    them) once on each distinct device of the mesh, as one entry per env
    shard: shards that share a device share its copy."""
    copies = {dev: _to(value, dev) for dev in mesh.distinct_devices}
    return tuple(copies[dev] for dev in mesh.shard_devices)


def map_shards(mesh: Mesh, fn) -> list:
    """`[fn(i) for i in range(mesh.n_env)]`, in shard order, from the
    calling thread, each shard under `torch.cuda.device` of its card. A
    shard's work that makes the host wait on its card (chunked regen's
    `.item()` reads, the rng replay) holds the next shards back; work that
    does not runs while they are launched. One host thread a card overlaps
    more on long kernels but measured 3.5–7.1 times slower on the host
    loops of random-layout regen, the train step and cached config 5
    (`tools/mesh_host_threads.py`, PERF.md §6). The parallel modules call
    it through this module, so one assignment here swaps the runner for
    all of them."""
    out = []
    for i, dev in enumerate(mesh.shard_devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            out.append(fn(i))
    return out
