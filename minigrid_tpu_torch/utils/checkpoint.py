"""Checkpoint / resume for env states, packed carries and train states
(counterpart of `minigrid_tpu/utils/checkpoint.py`).

The reference has no save/restore at all (SURVEY.md §5). Here a state is
a tree of tensors — an `EnvState` (dataclass), a `PackedCarry` or a
`TrainState` (named tuples; a train state's `ActorCritic` by its
`state_dict`), dicts, lists, tuples — so an exact save is `torch.save` of
the leaves, on the CPU, beside a structure tag: a plain dict that
`torch.load(..., weights_only=True)` reads. Loading into a structure whose
tag differs raises, as the JAX package's treedef check does.

`save_sharded` / `load_sharded` are the counterpart of the JAX package's
orbax pair for the shards of a mesh (`parallel/sharding.py::shard_states`,
`parallel/packed.py::shard_carry`): one file a shard, each restored onto
its own shard's device.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, List, Sequence

import torch
from torch import nn

from minigrid_tpu_torch.core import prng


def _tag(tree: Any, leaves: List[torch.Tensor]) -> str:
    """The structure tag of `tree`; its tensors are appended to `leaves`
    in the tag's order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, nn.Module):
        sd = tree.state_dict()
        leaves.extend(sd.values())
        return f"{type(tree).__name__}[{', '.join(sd)}]"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return f"{type(tree).__name__}({', '.join(f'{n}={_tag(getattr(tree, n), leaves)}' for n in names)})"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}({', '.join(f'{n}={_tag(getattr(tree, n), leaves)}' for n in tree._fields)})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_tag(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_tag(x, leaves) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _rebuild(like: Any, leaves, device: torch.device) -> Any:
    """`like`'s structure with the next leaves of the iterator `leaves`,
    moved to `device`."""
    if isinstance(like, torch.Tensor):
        return next(leaves).to(device)
    if like is None:
        return None
    if isinstance(like, nn.Module):
        module = copy.deepcopy(like).to(device)
        module.load_state_dict({k: next(leaves) for k in like.state_dict()})
        return module
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), leaves, device) for f in dataclasses.fields(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), leaves, device) for n in like._fields))
    if isinstance(like, dict):
        values = {k: _rebuild(like[k], leaves, device) for k in sorted(like)}
        return {k: values[k] for k in like}
    rebuilt = [_rebuild(x, leaves, device) for x in like]
    return rebuilt if isinstance(like, list) else tuple(rebuilt)


def structure(tree: Any) -> str:
    """The structure tag `save_pytree` stores for `tree`."""
    return _tag(tree, [])


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors to one file (exact, through the CPU)."""
    leaves: List[torch.Tensor] = []
    tag = _tag(tree, leaves)
    torch.save({"structure": tag, "leaves": [t.detach().cpu() for t in leaves]}, path)


def load_pytree(path: str, like: Any, device=None) -> Any:
    """Load a tree saved by `save_pytree` into `like`'s structure, its
    tensors on `device` (default: the card; pass `like`'s device to
    restore where it lies). A structure that differs from the saved one
    raises `ValueError`: loading it would reorder leaves."""
    device = prng.default_device(device)
    data = torch.load(path, map_location="cpu", weights_only=True)
    want = structure(like)
    if data["structure"] != want:
        raise ValueError(f"checkpoint structure mismatch:\n  saved: {data['structure']}\n  like:  {want}")
    return _rebuild(like, iter(data["leaves"]), device)


def _shard_file(path: str, i: int) -> str:
    return os.path.join(path, f"shard_{i}.pt")


def save_sharded(path: str, shards: Sequence[Any]) -> None:
    """Save the shards of a mesh (one tree each, on its own device) into
    the directory `path`, one file a shard."""
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(path):
        if name.startswith("shard_"):
            os.remove(os.path.join(path, name))
    for i, shard in enumerate(shards):
        save_pytree(_shard_file(path, i), shard)


def _device_of(tree: Any) -> torch.device:
    leaves: List[torch.Tensor] = []
    _tag(tree, leaves)
    if not leaves:
        raise ValueError("a shard holds no tensor to take a device from")
    return leaves[0].device


def load_sharded(path: str, like: Sequence[Any]) -> tuple:
    """Load the shards `save_sharded` wrote, each into the structure of
    `like`'s shard and onto that shard's device. A different shard count
    raises `ValueError`."""
    saved = sum(1 for name in os.listdir(path) if name.startswith("shard_"))
    if saved != len(like):
        raise ValueError(f"checkpoint holds {saved} shards, `like` {len(like)}")
    return tuple(load_pytree(_shard_file(path, i), s, device=_device_of(s)) for i, s in enumerate(like))
