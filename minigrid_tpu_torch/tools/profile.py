"""Profiling / tracing utilities (counterpart of
`minigrid_tpu/tools/profile.py`).

  * `trace(log_dir)` — context manager around `torch.profiler.profile`
    (host and, on the card, CUDA activity) that writes a Chrome trace,
    `log_dir/trace.json`, of the enclosed region.
  * `annotate(name)` — a named region (`torch.profiler.record_function`)
    inside an active trace.
  * `timed_steps_per_sec(...)` — best-of throughput of a callable, fenced
    by `torch.cuda.synchronize()` on each card its result lies on.

Usage:
    from minigrid_tpu_torch.tools.profile import trace, timed_steps_per_sec
    with trace("/tmp/mg_trace"):
        carry, metrics = step(key(1), carry)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch

from minigrid_tpu_torch.core import prng

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write its Chrome trace to
    `log_dir/trace.json`. On `device` (default: the card) a CUDA device
    adds the CUDA activity; `device="cpu"` traces the host alone."""
    device = prng.default_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace (host-side annotation)."""
    with torch.profiler.record_function(name):
        yield


def _tensors(result) -> Iterator[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)
    elif hasattr(result, "__dataclass_fields__"):
        for name in result.__dataclass_fields__:
            yield from _tensors(getattr(result, name))


def synchronize(result) -> None:
    """Wait for every card that holds a tensor of `result` (a tensor, or
    dicts, lists, tuples and dataclasses of them)."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed_steps_per_sec(
    fn: Callable,
    *args,
    steps_per_call: int,
    iters: int = 5,
    warmup: int = 1,
    fence: Optional[Callable] = None,
) -> float:
    """Best-of-`iters` steps/s of `fn(*args)`.

    `fence(result)` must wait for the result (default: `synchronize`);
    `steps_per_call` is the number of env steps one call simulates (batch
    × steps)."""
    fence = fence or synchronize
    for _ in range(warmup):
        fence(fn(*args))
    best = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fence(fn(*args))
        dt = time.perf_counter() - t0
        best = max(best, steps_per_call / dt)
    return best
