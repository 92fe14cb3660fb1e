"""The device trace of a few calls under `torch.profiler`: every device
activity's interval per card, and the host's pieces of each call (the
program's `mark` points, as profiler ranges) to name what the host was
doing while a card sat idle."""

from __future__ import annotations

from dataclasses import dataclass, field

from gpubench.harness import stats

END_OF_CALL = "end of call (host waits on the card)"
BETWEEN_CALLS = "between calls"


@dataclass
class Trace:
    """Times in microseconds of the profiler's clock."""

    lo: float
    hi: float
    calls: int
    devices: dict = field(default_factory=dict)  # card index -> [(start, end, name)]
    host: list = field(default_factory=list)  # [(start, end, piece)]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def intervals(self, device):
        return [(s, e) for s, e, _ in self.devices.get(device, [])]

    def busy_s(self, device) -> float:
        return stats.union_length(self.intervals(device), self.lo, self.hi) / 1e6

    def idle_pct(self, device) -> float:
        return stats.idle_pct(self.intervals(device), self.lo, self.hi)

    def kernel_s(self, *names) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(e - s for iv in self.devices.values() for s, e, n in iv if any(k in n for k in names)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for iv in self.devices.values():
            for s, e, n in iv:
                ops[n[:160]] = ops.get(n[:160], 0.0) + (e - s) / 1e6
        idle = {}
        for d in self.devices:
            for s, e in stats.gaps(self.intervals(d), self.lo, self.hi):
                covered = 0.0
                for hs, he, piece in self.host:
                    part = min(e, he) - max(s, hs)
                    if part > 0:
                        idle[piece] = idle.get(piece, 0.0) + part / 1e6 / len(self.devices)
                        covered += part
                if e - s - covered > 0:
                    idle[BETWEEN_CALLS] = idle.get(BETWEEN_CALLS, 0.0) + (e - s - covered) / 1e6 / len(self.devices)
        return {
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
        }


class Annotator:
    """The `mark` of a profiled call: each piece of the host's work between
    two marks becomes a profiler range, named after the mark that ends it
    once the call is over."""

    def __init__(self):
        from torch.autograd.profiler import record_function

        self._rf = record_function
        self.pieces = []
        self._open = []

    def _enter(self, name):
        rf = self._rf(name)
        rf.__enter__()
        self._open.append(rf)

    def _exit(self):
        self._open.pop().__exit__(None, None, None)

    def begin(self, i: int):
        self._i, self._cur = i, []
        self._enter(f"gpubench.call.{i}")
        self._enter(f"gpubench.seg.{i}.0")

    def mark(self, piece: str):
        self._exit()
        self._cur.append(piece)
        self._enter(f"gpubench.seg.{self._i}.{len(self._cur)}")

    def end(self):
        self._exit()
        self._exit()
        self.pieces.append(self._cur)


def traced(run_call, n_calls: int, synchronize) -> Trace:
    """`run_call(i, mark)` for `n_calls` calls under `torch.profiler`,
    each followed by `synchronize()`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ann = Annotator()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_calls):
            ann.begin(i)
            run_call(i, ann.mark)
            synchronize()
            ann.end()
    devices, host, calls = {}, [], []
    for e in prof.events():
        name = e.name
        s, t = e.time_range.start, e.time_range.end
        if name.startswith("gpubench.call."):
            if e.device_type == DeviceType.CPU:
                calls.append((s, t))
        elif name.startswith("gpubench.seg."):
            if e.device_type == DeviceType.CPU:
                i, j = (int(x) for x in name.split(".")[2:4])
                pieces = ann.pieces[i]
                host.append((s, t, pieces[j] if j < len(pieces) else END_OF_CALL))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            devices.setdefault(e.device_index, []).append((s, t, name))
    if not calls:
        raise RuntimeError("the profiler recorded none of the traced calls")
    return Trace(min(s for s, _ in calls), max(t for _, t in calls), n_calls, devices, host)
