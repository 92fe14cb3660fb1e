#!/usr/bin/env python3
"""The connect kernel (B4) and the room-chain kernel (B5) at each starting
width, and an earlier design's kernels, timed on the card at
`chip_smoke.py`'s shapes and on the main path's own launches.

    python3 tools/gen_kernel_sweep.py [--parent DIR] [--reps N] [--traffic] [--end-to-end N [--phases P ...]]

Kernels: this checkout's library (B4 two threads a lane at the start, B5
one attempt in flight), and this checkout's `ops/csrc/gen_kernel.cu`
built alone with nvcc at the other starting widths
(`-DMG_CONNECT_THREADS=1, 4, 8`, `-DMG_CHAIN_ATTEMPTS=2, 4`) into
`build/gen_kernel_sweep/`. With `--parent DIR`, also DIR's
`minigrid_tpu_torch/ops/csrc/gen_kernel.cu` built alone (the same C
interface: commit 6ca400a's one-thread-a-lane design has it). Every
kernel is launched through its library's `mg_connect_launch` or
`mg_mr_chain_launch` on the same inputs.

Cases: B4 on KeyCorridorS6R3's generator plan for 32,768 lanes (phase
9b's inputs, `chip_smoke.kc_connect_inputs`); B5 on the retry keys and
room counts of MultiRoom-N4-S5 and N6 for 32,768 lanes (phase 11a's,
`chip_smoke.mr_chain_inputs`). With `--traffic`, also every launch that
`chip_smoke.py`'s phases 8 (KeyCorridorS6R3 regen: B4) and 10
(MultiRoom-N4-S5 regen: B5) make, caught at the wrappers with their
inputs (the template refresh regenerates only its consumed lanes), and
each kernel's time summed over a phase's launches. Each kernel is held
against the plain version byte for byte and timed by CUDA events (the
mean of N launches after a warm one), in the order kernels, kernels
reversed; each time printed is the mean of its two turns.

With `--end-to-end N` (needs `--parent`), N rounds of parent, change,
change, parent run phases 8, 10 (a, b) and 12 (a-c), or those that
`--phases` names, with the wrappers' kernels swapped in this one process: "parent" launches DIR's kernels
where the wrappers launch this checkout's, and nothing else differs.
Each run prints its rates; the metrics (episodes, checksums, rewards,
losses) must be the same in every run, and a line says whether they
were.

Prints one line per row, then every row as one JSON object. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KC_ID = "MiniGrid-KeyCorridorS6R3-v0"
MR_IDS = ("MiniGrid-MultiRoom-N4-S5-v0", "MiniGrid-MultiRoom-N6-v0")
B = 32_768
SOURCE = ROOT / "minigrid_tpu_torch" / "ops" / "csrc" / "gen_kernel.cu"
# The other starting widths, each a library of its own: (kernel, label, nvcc define).
WIDTHS = [("connect", f"{w} thread{'s' * (w > 1)} a lane", f"-DMG_CONNECT_THREADS={w}") for w in (1, 4, 8)]
WIDTHS += [("room-chain", f"{a} attempts in flight", f"-DMG_CHAIN_ATTEMPTS={a}") for a in (2, 4)]
OWN = {"connect": "2 threads a lane (this checkout)", "room-chain": "1 attempt in flight (this checkout)"}
PARENT = "parent (one thread a lane)"


def build_alone(jobs):
    """`jobs`: (name, source, nvcc defines). Builds each source alone into
    `build/gen_kernel_sweep/`, all at once; returns {name: library}."""
    import chip_smoke
    from minigrid_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "gen_kernel_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src, defines) in enumerate(jobs):
        out = out_dir / f"libgen_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(out), str(src)]
        procs[name] = (out, src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, src, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({name}):\n{log}")
        print(f"built {name}: {src}", flush=True)
        chip_smoke.compiler_report(log)
        lib = ctypes.CDLL(str(out))
        ptr = ctypes.c_void_p
        lib.mg_connect_launch.argtypes = [ptr] * 8 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [ptr]
        lib.mg_connect_launch.restype = ctypes.c_int
        lib.mg_mr_chain_launch.argtypes = [ptr] * 6 + [ctypes.c_int] * 6 + [ptr]
        lib.mg_mr_chain_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch_connect(lib, keys, start_i, start_j, locked_bits, hd0, rows, cols, max_itrs):
    import torch

    from minigrid_tpu_torch.envs.roomgrid import COLOR_ORDER

    b, dev = keys.shape[1], keys.device
    outs = (torch.empty((4, b), dtype=torch.int32, device=dev),
            torch.empty((rows * cols * 4, b), dtype=torch.int32, device=dev),
            torch.empty((1, b), dtype=torch.int32, device=dev))
    err = lib.mg_connect_launch(
        *(ctypes.c_void_p(x.data_ptr()) for x in (keys, start_i, start_j, locked_bits, hd0, *outs)),
        (ctypes.c_int * 6)(*COLOR_ORDER), b, rows, cols, max_itrs,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"connect kernel: CUDA error {err}")
    return outs


def launch_chain(lib, keys, num_rooms, cfg, max_attempts):
    import torch

    b, dev = keys.shape[1], keys.device
    nmax = cfg.max_num_rooms
    outs = (torch.empty((6, nmax, b), dtype=torch.int32, device=dev),
            *(torch.empty((1, b), dtype=torch.int32, device=dev) for _ in range(3)))
    err = lib.mg_mr_chain_launch(
        *(ctypes.c_void_p(x.data_ptr()) for x in (keys, num_rooms, *outs)),
        b, cfg.width, cfg.height, nmax, cfg.max_room_size, max_attempts,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"room-chain kernel: CUDA error {err}")
    return outs


def time_ms(fn, reps):
    import torch

    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def time_case(kind, label, args, libs, reps, card):
    """Every kernel of `libs` ({name: library}) on one launch's arguments,
    each held against the plain version. Returns the rows."""
    import torch

    from minigrid_tpu_torch.ops import gen_kernel as gk

    launch, plain = (launch_connect, gk.plain_connect_plan) if kind == "connect" else (launch_chain, gk.plain_mr_chain)
    want = plain(*args)
    times, outs = {}, {}
    for name in list(libs) + list(reversed(list(libs))):
        ms, outs[name] = time_ms(lambda: launch(libs[name], *args), reps)
        times.setdefault(name, []).append(ms)
    b = args[0].shape[1]
    rows = []
    for name, ts in times.items():
        same = all(torch.equal(g, x) for g, x in zip(outs[name], want))
        ms = sum(ts) / len(ts)
        rows.append({"kernel": kind, "case": label, "b": b, "what": name, "ms": ms, "turns_ms": ts,
                     "same_as_plain": same, "card": card})
        print(f"{kind} {label} B={b}: {name}: {ms:.6f} ms (turns {', '.join(f'{t:.6f}' for t in ts)}); "
              f"same as plain: {same} [{card}]", flush=True)
        if not same:
            raise RuntimeError(f"{kind} {label} {name} differs from the plain version")
    return rows


def catch_traffic(dev, card):
    """The arguments of every B4 launch of phase 8 and every B5 launch of
    phase 10, caught at the wrappers (cloned, so that they outlive the
    phases' buffers)."""
    import torch

    import chip_smoke
    from minigrid_tpu_torch.ops import gen_kernel as gk

    caught = []
    run_connect, run_chain = gk.run_connect_kernel, gk.run_mr_chain_kernel

    def keep(kind, run):
        def call(*a):
            caught.append((kind, tuple(x.clone() if torch.is_tensor(x) else x for x in a)))
            return run(*a)
        return call

    gk.run_connect_kernel, gk.run_mr_chain_kernel = keep("connect", run_connect), keep("room-chain", run_chain)
    try:
        chip_smoke.phase_kc_main_path(dev, card)
        chip_smoke.phase_mr_main_path(dev, card)
    finally:
        gk.run_connect_kernel, gk.run_mr_chain_kernel = run_connect, run_chain
    return caught


def traffic_sums(rows, card):
    """Per kernel: each library's time summed over the phase's launches."""
    sums = []
    for kind in ("connect", "room-chain"):
        mine = [r for r in rows if r["kernel"] == kind and r["case"].startswith("traffic")]
        if not mine:
            continue
        total = {}
        for r in mine:
            total[r["what"]] = total.get(r["what"], 0.0) + r["ms"]
        lanes = [b for _, b in sorted({(r["case"], r["b"]) for r in mine})]
        sums.append({"kernel": kind, "launches": len(lanes), "lanes": lanes, "sum_ms": total, "card": card})
        print(f"{kind} traffic: {len(lanes)} launches, lanes {lanes}; summed ms "
              f"{ {k: round(v, 6) for k, v in total.items()} } [{card}]", flush=True)
    return sums


def _phase_8(dev, card):
    import chip_smoke

    kc = chip_smoke.phase_kc_main_path(dev, card)[4]
    rates = {f"phase 8: regen_chunk {c}": r["rate"] for c, r in kc.items()}
    return rates, {f"phase 8: regen_chunk {c}": [r["episodes"], r["obs_checksum"], r["reward"]] for c, r in kc.items()}


def _phase_10(dev, card):
    import chip_smoke

    _, _, rand, policy = chip_smoke.phase_mr_main_path(dev, card)
    rates, metrics = {}, {}
    for name, w in (("phase 10a", rand), ("phase 10b", policy)):
        rates[name] = w[3]
        metrics[name] = [[int(m.episodes), int(m.obs_checksum), float(m.total_reward)] for m in w[1]]
    return rates, metrics


def _phase_12(dev, card):
    import chip_smoke

    regen = chip_smoke.phase_regen_policy_main_path(dev, card)[2]
    rates = {f"phase 12{tag}": r for tag, r in regen["rates"].items()}
    metrics = {"phase 12a": [[int(m.episodes), int(m.obs_checksum)] for m in regen["kc_eval"][1]]}
    for tag in ("b", "c"):
        metrics[f"phase 12{tag}"] = [float(m["loss"]) for m in regen[f"train_{tag}"][2]]
    return rates, metrics


# The main paths `--end-to-end` runs: each returns ({window: env-steps/s},
# {window: metrics}).
PHASES = {"8": _phase_8, "10": _phase_10, "12": _phase_12}


def end_to_end(rounds, phases, parent, dev, card):
    """The `phases` of `PHASES` in rounds of parent, change, change,
    parent, the wrappers' kernels swapped in this process."""
    import torch

    from minigrid_tpu_torch.ops import gen_kernel as gk

    run_connect, run_chain = gk.run_connect_kernel, gk.run_mr_chain_kernel

    def old_connect(*a):
        out = launch_connect(parent, *a)
        gk.connect_kernel_launches += 1
        return out

    def old_chain(*a):
        out = launch_chain(parent, *a)
        gk.mr_chain_kernel_launches += 1
        return out

    runs = []
    for _ in range(rounds):
        for which in ("parent", "change", "change", "parent"):
            rates, metrics = {}, {}
            if which == "parent":
                gk.run_connect_kernel, gk.run_mr_chain_kernel = old_connect, old_chain
            try:
                for phase in phases:
                    r, m = PHASES[phase](dev, card)
                    rates.update(r)
                    metrics.update(m)
            finally:
                gk.run_connect_kernel, gk.run_mr_chain_kernel = run_connect, run_chain
            torch.cuda.empty_cache()
            runs.append({"kernels": which, "rates": rates, "metrics": metrics, "card": card})
            print(f"end to end, {which}'s kernels: {json.dumps(rates)} [{card}]", flush=True)
    same = all(r["metrics"] == runs[0]["metrics"] for r in runs)
    print(f"end to end: the metrics are the same in every run: {same}", flush=True)
    for name in runs[0]["rates"]:
        by = {w: [r["rates"][name] for r in runs if r["kernels"] == w] for w in ("parent", "change")}
        mean = {w: sum(v) / len(v) for w, v in by.items()}
        print(f"end to end, {name}: parent {by['parent']} (mean {mean['parent']:.6e}), change {by['change']} "
              f"(mean {mean['change']:.6e}); change / parent {mean['change'] / mean['parent']:.4f} [{card}]",
              flush=True)
    return runs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--traffic", action="store_true")
    parser.add_argument("--end-to-end", type=int, default=0)
    parser.add_argument("--phases", nargs="+", choices=list(PHASES), default=list(PHASES))
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("gen_kernel_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    if opts.end_to_end and not opts.parent:
        parser.error("--end-to-end needs --parent")
    import chip_smoke
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    if _build.last_build_log:
        chip_smoke.REPORTED_KERNELS = ("connect_kernel", "mr_chain_kernel")
        chip_smoke.compiler_report(_build.last_build_log)
    own = _build.load_library(dev)
    jobs = [(label, SOURCE, [define]) for _, label, define in WIDTHS]
    if opts.parent:
        jobs.append((PARENT, opts.parent / "minigrid_tpu_torch" / "ops" / "csrc" / "gen_kernel.cu", []))
    built = build_alone(jobs)
    libs = {kind: {OWN[kind]: own, **{label: built[label] for k, label, _ in WIDTHS if k == kind}}
            for kind in ("connect", "room-chain")}
    if opts.parent:
        for kind in libs:
            libs[kind][PARENT] = built[PARENT]

    cases = [("connect", KC_ID, chip_smoke.kc_connect_inputs(make(KC_ID).config, B, dev))]
    cases += [("room-chain", env_id, chip_smoke.mr_chain_inputs(make(env_id).config, B, dev)) for env_id in MR_IDS]
    if opts.traffic:
        phase = {"connect": "phase 8", "room-chain": "phase 10"}
        caught = catch_traffic(dev, card)
        cases += [(kind, f"traffic {phase[kind]} launch {i}", args) for i, (kind, args) in enumerate(caught)]
    rows = []
    for kind, label, args in cases:
        rows += time_case(kind, label, args, libs[kind], opts.reps, card)
    out = {"rows": rows, "traffic": traffic_sums(rows, card) if opts.traffic else []}
    if opts.end_to_end:
        out["end_to_end"] = end_to_end(opts.end_to_end, opts.phases, built[PARENT], dev, card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
