"""One run of one cell: set-up, the measured window, the traced calls, the
comparison with the plain reference, and the result line."""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass

from gpubench.harness import spec, stats, trace

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "minigrid_tpu"})


@dataclass
class Check:
    """One number the comparison reads, and the largest it may be."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Marks:
    """The program's `mark` during the window: a CUDA event (on the CPU,
    the host's clock) at the start of each call and at each piece's end."""

    def __init__(self, cuda: bool):
        import torch

        self._cuda, self._torch = cuda, torch
        self.calls = []

    def _now(self):
        if not self._cuda:
            return time.perf_counter()
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self):
        self._cur = [(None, self._now())]

    def mark(self, piece: str):
        self._cur.append((piece, self._now()))

    def end(self):
        self.calls.append(self._cur)

    def pieces_ms(self):
        """Per call, `[(piece, ms)]` in the order marked."""
        out = []
        for call in self.calls:
            row = []
            for (_, a), (piece, b) in zip(call, call[1:]):
                row.append((piece, a.elapsed_time(b) if self._cuda else (b - a) * 1e3))
            out.append(row)
        return out


class Run:
    """What the metric readers read (`metrics/<name>.py::read(run)`)."""

    def __init__(self, cell, setup_s, calls_s, window_s, work_per_call, marks=None, counters=None, traced=None):
        self.cell, self.setup_s, self.calls_s, self.window_s = cell, setup_s, calls_s, window_s
        self.work_per_call = work_per_call
        self.marks = marks or []
        self.counters = counters or {}
        self.trace = traced

    def rate(self) -> float:
        """All the window's work over all its time."""
        return self.work_per_call * len(self.calls_s) / self.window_s

    def call_ms(self, q: int) -> float:
        """The `q`-th percentile of all the window's call times, in ms."""
        return 1e3 * stats.percentile(self.calls_s, q)

    def idle_pct(self):
        """The traced calls' idle share of the cell's cards, the mean over
        them; None without a trace."""
        if self.trace is None or not self.trace.devices:
            return None
        return sum(self.trace.idle_pct(d) for d in range(self.cell.chips)) / self.cell.chips

    def piece_ms(self, piece: str):
        """The mean over the window's calls of a piece's summed ms; None
        where no call marked it."""
        if not any(p == piece for call in self.marks for p, _ in call):
            return None
        return sum(ms for call in self.marks for p, ms in call if p == piece) / len(self.marks)

    def per_call(self, counter: str):
        if counter not in self.counters:
            return None
        return self.counters[counter] / len(self.calls_s)


def _no_mark(_piece: str) -> None:
    pass


def window(mode, seconds: float, synchronize, marks=None):
    """Calls until `seconds` have passed and the mode has made the calls
    its check needs: `(per-call seconds, window seconds)`."""
    calls, i = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if marks is not None:
            marks.begin()
        mode.call(i, marks.mark if marks is not None else _no_mark)
        synchronize()
        if marks is not None:
            marks.end()
        t1 = time.perf_counter()
        calls.append(t1 - t0)
        i += 1
        if t1 - start >= seconds and i >= mode.min_calls:
            return calls, t1 - start


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def refuse_forbidden() -> None:
    """Exits without a result where the process has loaded JAX or the JAX
    package, naming what it found."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"gpubench: modules of JAX or of the JAX package were loaded: {found}")


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return res.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float, after_setup=None) -> dict:
    """One run of `cell`; `t0` is the process's start on the host clock.
    `after_setup(mode)` may replace the mode's timed path (tests)."""
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mode = spec.mode_module(cell).Mode(cell, seed, device)
    sync()
    setup_s = time.perf_counter() - t0
    if after_setup is not None:
        after_setup(mode)
    before = mode.counters()
    marks = Marks(cuda) if traced else None
    calls_s, window_s = window(mode, seconds, sync, marks)
    counters = {k: v - before.get(k, 0) for k, v in mode.counters().items()}
    devices = mode.devices
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    tr = None
    if traced and cuda:
        n = len(calls_s)
        tr = trace.traced(lambda i, mark: mode.call(n + i, mark), cell.params["trace_calls"], sync)
    checks = mode.check()
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"] = sum(tr.busy_s(d.index) for d in devices) / len(devices)
        info["window_s"] = tr.window_s
    ctx = Run(cell, setup_s, calls_s, window_s, mode.work_per_call, marks.pieces_ms() if marks else None, counters,
              tr)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.metric_reader(cell, m)(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {"correct": all(c.ok for c in checks), "attempted": len(calls_s), "failed": 0, "metrics": metrics,
              "device": info}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    refuse_forbidden()
    if cuda:
        print(f"gpubench: {card_line()}; setup_s {setup_s:.3f}; {len(calls_s)} calls in {window_s:.3f} s",
              file=sys.stderr)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}){'' if c.ok else ' FAILED'}", file=sys.stderr)
    return result
