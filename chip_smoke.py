#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):
  1. The card's name and power limit (nvidia-smi), then the build of the
     CUDA kernels from the sources in this checkout, timed.
  2. The main path at full size: Empty-8x8, `reset_batch(key(0), 2**21)`,
     `packed_init(..., "regen")`, one warm-up and three timed
     `step(generator, carry)` calls at T=256, `packed_finish`. Every
     kernel's launch counter is set to 0 just before: the rollout kernel
     must launch exactly 4 times, and the probe kernel once (its launch
     check runs when the main path first loads the library). Then
     `total_steps == B*T`; agents in bounds; `0 <= step_count <
     max_steps`. Then one kernel call and one plain-twin call on the same
     carry and generator seed must agree byte for byte (carry, rng chain
     and metrics), and the kernel alone and the twin alone are timed with
     CUDA events.
  3. Each kernel against its plain version on the card. The rollout
     kernel on random packed states (`minigrid_tpu_torch/testing.py`),
     T=64, B=8192: 8x8 and 9x7 with and without see-through walls, 16x16
     and 25x25 without. Words, registers, episodes and checksum must be
     byte-exact and per-lane reward sums bit-identical (tolerance 0). The
     probe kernel on a random (8, 128) int32 block against `x + 1`,
     exact.

"""

from __future__ import annotations

import json
import subprocess
import sys
import time

ENV_ID = "MiniGrid-Empty-8x8-v0"
MAIN_B = 2_097_152
MAIN_T = 256
TIMED_CALLS = 3
CHECK_B = 8192
CHECK_T = 64
CHECK_CONFIGS = [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, False), (25, 25, False)]
KERNEL_SOURCE = "minigrid_tpu_torch/ops/csrc/rollout_kernel.cu"
KERNEL_REPLACES = "minigrid_tpu/ops/fused_rollout.py:519"
PROBE_REPLACES = "minigrid_tpu/utils/platform.py:48"
PROBE_REPS = 200


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def compare(got, want):
    """(mismatch count per output, max abs difference over all outputs);
    f32 outputs are compared as bit patterns."""
    import torch

    names = ("words", "regs", "rsum", "episodes", "checksum")
    counts, max_err = {}, 0.0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        gb, wb = (g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
        counts[name] = int((gb != wb).sum())
        max_err = max(max_err, float((g.double() - w.double()).abs().max()))
    return counts, max_err


def phase_kernel_vs_plain(dev, card):
    import numpy as np
    import torch

    from minigrid_tpu_torch.core.state import EnvConfig
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.testing import random_packed_case

    max_err = 0.0
    for w, h, stw in CHECK_CONFIGS:
        cfg = EnvConfig(family="empty", width=w, height=h, max_steps=4 * w * h, see_through_walls=stw)
        case = random_packed_case(w * h + stw, w, h, CHECK_B, cfg.max_steps)
        args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
        rng = np.random.default_rng(w * h)
        actions = torch.from_numpy(rng.integers(0, 7, (CHECK_T, CHECK_B)).astype(np.int32)).to(dev)
        got = fr.run_rollout_kernel(*args, actions, cfg)
        want = fr.plain_rollout(*args, actions, cfg)
        torch.cuda.synchronize()
        counts, err = compare(got, want)
        max_err = max(max_err, err)
        episodes = int(want[3].sum())
        print(f"phase 3: {w}x{h} see_through_walls={stw} B={CHECK_B} T={CHECK_T} "
              f"episodes={episodes} mismatches={counts} max_abs_err={err}", flush=True)
        if any(counts.values()) or episodes == 0:
            raise RuntimeError(f"phase 3 failed on {w}x{h} see_through_walls={stw}")
    return max_err


def phase_probe(dev, card):
    """The probe kernel against `x + 1` on a random (8, 128) int32 block,
    exact; both timed with CUDA events."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.ops import _build

    x = np.random.default_rng(0).integers(-(2**31), 2**31 - 1, _build.PROBE_SHAPE, dtype=np.int32)
    x = torch.from_numpy(x).to(dev)
    _build.probe(x)  # warm
    ms, got = time_events(lambda: _build.probe(x), PROBE_REPS)
    plain_ms, want = time_events(lambda: x + 1, PROBE_REPS)
    mismatches = int((got != want).sum())
    err = float((got.double() - want.double()).abs().max())
    print(f"phase 3: probe kernel {tuple(x.shape)} {ms:.6f} ms/call, plain x+1 {plain_ms:.6f} ms/call, "
          f"mismatches={mismatches} max_abs_err={err} [{card}]", flush=True)
    if mismatches:
        raise RuntimeError("phase 3 failed: the probe kernel differs from x + 1")
    return err, ms, plain_ms


def time_events(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_main_path(dev, card):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.rollout import random_policy
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import fused_rollout as fr

    # Every kernel's count starts at 0 here and is read right after
    # `packed_finish`: they count only the main path's launches.
    fr.rollout_kernel_launches = 0
    _build.probe_launches = 0
    env = make(ENV_ID)
    cfg = env.config
    t0 = time.perf_counter()
    states = env.reset_batch(key(0, device=dev), MAIN_B)
    carry = fr.packed_init(env, states, "regen")
    torch.cuda.synchronize()
    print(f"phase 2: {ENV_ID} B={MAIN_B} T={MAIN_T} regen: reset_batch + packed_init "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    step = fr.build_fused_rollout(env, MAIN_T, mode="regen", as_carry=True)
    gen = torch.Generator(device=dev).manual_seed(1)

    torch.cuda.synchronize()
    carry, metrics = step(gen, carry)  # warm-up
    warm_carry = carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episodes = 0
    for _ in range(TIMED_CALLS):
        carry, metrics = step(gen, carry)
        episodes += int(metrics.episodes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    final = fr.packed_finish(env, carry)
    torch.cuda.synchronize()
    launches = {"rollout_kernel": fr.rollout_kernel_launches, "probe_kernel": _build.probe_launches}

    steps_per_s = MAIN_B * MAIN_T * TIMED_CALLS / seconds
    print(f"phase 2: kernel path {TIMED_CALLS} step calls {seconds:.4f} s, "
          f"{steps_per_s:.6e} env-steps/s, episodes {episodes} [{card}]", flush=True)
    print(f"phase 2: launches on the main path {launches}", flush=True)
    if launches != {"rollout_kernel": 1 + TIMED_CALLS, "probe_kernel": 1}:
        raise RuntimeError(f"main path launches {launches}, expected {1 + TIMED_CALLS} and 1")
    if int(metrics.total_steps) != MAIN_B * MAIN_T:
        raise RuntimeError(f"total_steps {int(metrics.total_steps)} != {MAIN_B * MAIN_T}")
    x, y = final.agent_pos[:, 0], final.agent_pos[:, 1]
    if not bool(((x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)).all()):
        raise RuntimeError("an agent left the room's interior")
    sc = final.step_count
    if not bool(((sc >= 0) & (sc < cfg.max_steps)).all()):
        raise RuntimeError("step_count out of [0, max_steps)")
    if episodes == 0 or int(metrics.obs_checksum) == 0:
        raise RuntimeError("no episode ended, or the checksum is 0: the rollout did not run")

    # The same carry and actions through the kernel and the plain twin.
    plain_step = fr.build_packed_plain_rollout(env, MAIN_T, mode="regen", as_carry=True)
    results = []
    for fn in (step, plain_step):
        g = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn(g, warm_carry))
        torch.cuda.synchronize()
        results[-1] += (time.perf_counter() - t0,)
    (ck, mk, sk), (cp, mp, sp) = results
    bad = [n for n, a, b in zip(ck._fields, ck, cp) if not torch.equal(a, b)]
    bad += [n for n, a, b in zip(mk._fields, mk, mp) if not torch.equal(a, b)]
    print(f"phase 2: kernel step call {sk:.4f} s vs plain step call {sp:.4f} s on the same carry; "
          f"plain {MAIN_B * MAIN_T / sp:.6e} env-steps/s [{card}]; differing: {bad or 'none'}", flush=True)
    if bad:
        raise RuntimeError(f"kernel and plain twin differ at full size in {bad}")

    # The kernel alone and the twin alone, on fixed actions.
    actions = random_policy(cfg.num_actions)(torch.Generator(device=dev).manual_seed(11), MAIN_T, MAIN_B)
    args = (warm_carry.words, warm_carry.regs, warm_carry.tmpl_words, warm_carry.tmpl_regs, actions, cfg)
    fr.run_rollout_kernel(*args)  # warm
    kernel_ms, got = time_events(lambda: fr.run_rollout_kernel(*args), 5)
    plain_ms, want = time_events(lambda: fr.plain_rollout(*args), 1)
    counts, max_err = compare(got, want)
    print(f"phase 2: rollout kernel {kernel_ms:.4f} ms/call ({MAIN_B * MAIN_T / kernel_ms * 1e3:.6e} "
          f"env-steps/s), plain twin {plain_ms:.4f} ms/call ({MAIN_B * MAIN_T / plain_ms * 1e3:.6e} "
          f"env-steps/s), mismatches={counts} [{card}]", flush=True)
    if any(counts.values()):
        raise RuntimeError("kernel and plain twin differ on fixed actions at full size")
    return launches, max_err, kernel_ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    from minigrid_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds} s; library {_build.library_path().name})", flush=True)
    if _build.last_build_log:
        print(_build.last_build_log.strip(), flush=True)

    launches, err2, kernel_ms, plain_ms = phase_main_path(dev, card)
    err3 = phase_kernel_vs_plain(dev, card)
    probe_err, probe_ms, probe_plain_ms = phase_probe(dev, card)

    print(json.dumps({"kernels": [
        {
            "name": "rollout_kernel",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches["rollout_kernel"],
            "max_abs_err": max(err2, err3),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "probe_kernel",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": PROBE_REPLACES,
            "launches": launches["probe_kernel"],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
