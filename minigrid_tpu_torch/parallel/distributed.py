"""Several processes over one mesh, on `torch.distributed` (counterpart of
`minigrid_tpu/parallel/distributed.py`).

Every process runs the same program on its own env shards: its part of
the job's global mesh (`global_env_mesh`: its shards and the global index
of its first), the lanes of the global batch those shards hold
(`make_global_batch`), and the collectives that join the processes: the
metrics' sum (`psum_metrics`) and, in the train steps, the gradient sums
before the update (`all_reduce_sum`). A shard's draws depend on its global
index, so a run over two processes of four shards each equals a run over
one process of the same eight shards (float sums aside).

Nothing on a machine tells a process of the job: pass the coordinator's
address (`host:port`), the process count and this process's index to
`initialize`. The process group is NCCL's on the card and gloo's on the
CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvState
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.parallel.sharding import Mesh, make_env_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the job's process group (a no-op for one process without an
    address, as the JAX package's is): `init_process_group` at
    `tcp://<coordinator_address>` with `num_processes` ranks, this one
    `process_id`. `backend` defaults to NCCL, which needs a card, and
    raises without one: pass `backend="gloo"` for CPU shards."""
    if not ((num_processes or 1) > 1 or coordinator_address):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs coordinator_address, num_processes and process_id")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass backend='gloo' to join CPU processes")
        backend = "nccl"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _joined() -> bool:
    """True once `initialize` made a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def _group_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced in place by its sum over the job's processes
    (nothing happens without a process group)."""
    if not _joined():
        return
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)


def global_env_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> Mesh:
    """This process's part of the job's mesh: `make_env_mesh(devices,
    model_parallel)` with the global index of its first env shard
    (`shard_offset`) and the job's env shards (`global_shards`), the
    processes' shards in rank order."""
    mesh = make_env_mesh(devices, model_parallel)
    if not _joined():
        return mesh
    counts = [torch.zeros(1, dtype=torch.int64, device=_group_device()) for _ in range(dist.get_world_size())]
    dist.all_gather(counts, torch.tensor([mesh.n_env], dtype=torch.int64, device=_group_device()))
    counts = [int(c) for c in counts]
    return dataclasses.replace(mesh, shard_offset=sum(counts[: dist.get_rank()]), global_shards=sum(counts))


def make_global_batch(env: Env, key: torch.Tensor, global_batch: int, mesh: Mesh) -> Tuple[Tuple[EnvState, ...], torch.Tensor]:
    """The lanes of a `global_batch`-lane batch that this process's shards
    hold: `split(key, global_batch)` sliced to them (drawn without the
    rest), then `Env.reset` of each shard's keys on its device, as
    `jax.vmap(env.reset)` generates each key's env. No process makes the
    whole batch. Returns (the sharded `EnvState`, this process's keys)."""
    n = mesh.n_global
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over {n} env shards")
    b = global_batch // n
    lo = mesh.shard_offset * b
    idx = torch.arange(lo, lo + mesh.n_env * b, dtype=torch.int64, device=key.device)
    y0, y1 = prng.threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)  # split(key, global_batch)[lo:...]
    keys = torch.stack([y0, y1], dim=-1)
    states = tuple(
        env.reset(keys[i * b : (i + 1) * b].to(dev))[0] for i, dev in enumerate(mesh.shard_devices)
    )
    return states, keys


def psum_metrics(metrics, mesh: Optional[Mesh] = None):
    """A NamedTuple (or dict) of 0-d metrics summed over the job's
    processes by `all_reduce` (new tensors); without a process group, the
    metrics as they are (the shards' sum is already in them)."""
    if not _joined():
        return metrics
    if isinstance(metrics, dict):
        out = {k: v.clone() for k, v in metrics.items()}
        all_reduce_sum(list(out.values()))
        return out
    out = [v.clone() for v in metrics]
    all_reduce_sum(out)
    return type(metrics)(*out)


def process_info(mesh: Optional[Mesh] = None) -> dict:
    """The JAX package's four keys: this process's rank and the job's
    process count, and its and the job's devices, counted as the mesh's env
    shards where a mesh is given, else as the visible CUDA devices."""
    joined = _joined()
    if mesh is not None:
        local, total = mesh.n_env, mesh.n_global
    else:
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        total = local
        if joined:
            t = torch.tensor([local], dtype=torch.int64, device=_group_device())
            dist.all_reduce(t)
            total = int(t)
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_device_count": local,
        "global_device_count": total,
    }
