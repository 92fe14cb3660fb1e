"""Where one carry-surface `step` call, or one fused train step, of the
PyTorch port spends its time on a CUDA card.

    python tools/profile_step_torch.py [--env ID] [--batch B]           # random policy
    python tools/profile_step_torch.py --policy [--env ID] [--batch B]  # ActorCritic in the loop
    python tools/profile_step_torch.py --train [--env ID] [--batch B]   # the fused train step
    python tools/profile_step_torch.py --regen [--env ID] [--steps T] [--chunk N] [--batch B] [--policy]
                                                  # chunked regen
    python tools/profile_step_torch.py --train --regen [--env ID] [--steps T] [--chunk N] [--batch B]
                                                  # the train step on a random layout

At the main path's shape (Empty-8x8, B = 2**21, T = 256, as in
`chip_smoke.py`), runs the pieces of a regen `step(source, carry)` call
(`minigrid_tpu_torch.ops.fused_rollout._make_plain_carry_step`) one after
the other on the current stream, with a CUDA event between each:

  actions   the per-step input: the random policy's `(T, B)` int32 draw
            (`_action_stream`), or with `--policy` the sampling seeds
            (`policy_rollout._seeds_for`, Threefry in plain torch)
  kernel    the rollout kernel (`run_rollout_kernel`), or with `--policy`
            the policy kernel (`run_policy_kernel`, the seeded
            `ActorCritic` of `chip_smoke.py`)
  replay    the regen rng-chain replay (`_replay_rng_chain`); its
            `.item()` makes the host wait for the kernel, so the span also
            holds the gaps while the host launches the replay's ops
  sums      the metric sums

With `--env ID` (and `--batch B`), the same pieces on another id: regen
mode where its layout is static, cached mode otherwise (no replay), as
`chip_smoke.py` phase 17a times DynamicObstacles-16x16 cached (`--env
MiniGrid-Dynamic-Obstacles-16x16-v0 --batch 262144`: the "kernel" share
is the rollout kernel's, the obstacle walk included, of a call).

With `--train`, at the train path's shape (B = 131,072, T = 256, as in
`chip_smoke.py` phase 6; `--env` and `--batch` as above), the pieces of `train_step(ts, carry, key)`
(`minigrid_tpu_torch.parallel.train.build_fused_train_step`), timed by a
CUDA event that the step itself records at the end of each piece (its
`mark` argument), so the profile follows the step's own code:

  weights   the train-layout weights under autograd (`_train_weights`)
  seeds     the sampling seeds (`_seeds_for`)
  collect   the policy kernel in collect mode (trajectory spill)
  replay    the regen rng-chain replay
  returns   `_trajectory_returns` and the advantages
  grad      the gradient kernel (`build_grad_kernel`: G1 and G2 for every
            time chunk, then the partial sums and the torso's bf16
            rounding); the profiler table splits it into `grad_g1_kernel`
            and `grad_g2_kernel`
  pullback  the cotangents pulled back to the flax layout (`_pullback`)
  optimizer clip + Adam on the flat vector and the updated module

With `--regen`, at B = 32,768 (`--batch`) on a random-layout family
(`--env`, default KeyCorridorS6R3; T `--steps`, default 256;
`regen_chunk` `--chunk`, default 128: `chip_smoke.py` phase 8's shape;
phase 10's is `--env MiniGrid-MultiRoom-N4-S5-v0 --steps 288 --chunk 96`,
phase 15a's `--env MiniGrid-DoorKey-8x8-v0 --chunk 32 --batch 262144`),
the pieces
of a chunked-regen call
(`minigrid_tpu_torch.ops.chunked_regen.build_chunked_regen`), timed by
CUDA events the call records through its `mark` argument and summed over
its chunks:

  actions   the random policy's `(T, B)` draw, or with `--policy` the
            sampling seeds of the seeded `ActorCritic` in the loop
  kernel    pass 1 of each chunk: the rollout kernel (or the policy
            kernel) under the control rows
  refresh   the chain advance and the template refresh of the lanes that
            reset (`masked_template_refresh`: the family's packed
            generator, with the connect kernel or the room-chain kernel
            inside it, or its batched `generate`, packed); its lane count
            is read on the host
  reentry   the re-entry passes, the check for unfinished lanes included
  sums      the metrics

With `--train --regen`, at B = 32,768 on a random-layout family (default
KeyCorridorS6R3, T 256, chunk 32: `chip_smoke.py` phase 12b's shape;
phase 12c's is `--env MiniGrid-MultiRoom-N4-S5-v0 --steps 288 --chunk
96`), the pieces of one `train_step`: "weights", then chunked regen's
pieces as above (here "actions" are the sampling seeds and "kernel" the
collecting policy kernel, each pass's spill merged to the commit cursors),
then "returns", "grad", "pullback" and "optimizer", over the same window.

From `reset_batch` every step count is 0, so lanes truncate together at
`max_steps`: after one warm-up call it times a window of calls that holds
at least one mass reset (`ceil(max_steps / T)` calls, at least 3: 5 at
KeyCorridorS6R3, 3 at MultiRoom-N4-S5), then runs the next window under
`torch.profiler`, whose table splits the device time into the kernels
and the generator's torch ops.

It prints each piece's ms per call, averaged over 3 calls after 2 warm-up
calls (with `--regen`, over its window), beside a whole call timed the
same way. Then it wraps one whole
call in `torch.profiler` and prints the device-time table. The last line
is one JSON object with the numbers. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import chunked_regen as cr
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.ops import gen_kernel as gk
from minigrid_tpu_torch.ops import grad_kernel as grk
from minigrid_tpu_torch.ops import policy_rollout as pr
from minigrid_tpu_torch.parallel import train as tr

ENV_ID = "MiniGrid-Empty-8x8-v0"
BATCH = 2_097_152
NUM_STEPS = 256
WARMUP = 2
CALLS = 3
PIECES = ("actions", "kernel", "replay", "sums")
TRAIN_BATCH = 131_072
TRAIN_PIECES = ("weights", "seeds", "collect", "replay", "returns", "grad", "pullback", "optimizer")
TRAIN_REGEN_PIECES = ("weights", "actions", "kernel", "refresh", "reentry", "sums", "returns", "grad", "pullback",
                      "optimizer")
REGEN_ENV_ID = "MiniGrid-KeyCorridorS6R3-v0"
REGEN_BATCH = 32_768
REGEN_PIECES = ("actions", "kernel", "refresh", "reentry", "sums")
REGEN_KERNELS = ("rollout_kernel", "policy_kernel", "connect_kernel", "mr_chain_kernel")


def timed_pieces(env, num_steps, source, carry, stream_fn, run_core, mode="regen"):
    """One step call, piece by piece: (carry, ms per piece, replay
    iterations); cached mode has no replay (0 ms)."""
    cfg = env.config
    b, dev = carry.words.shape[1], carry.words.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(PIECES) + 1)]
    ev[0].record()
    stream = stream_fn(source, b, dev)
    ev[1].record()
    words, regs, rsum, epi, csum = run_core(
        carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, stream, cfg
    )
    ev[2].record()
    rng = fr._replay_rng_chain(env, carry.rng, epi[0]) if mode == "regen" else carry.rng
    ev[3].record()
    _sums = (epi.sum(dtype=torch.int64), rsum.sum(), csum.sum(dtype=torch.int64))
    ev[4].record()
    torch.cuda.synchronize()
    ms = {p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(PIECES)}
    iterations = int(epi.max()) if mode == "regen" else 0
    return fr.PackedCarry(words, regs, carry.tmpl_words, carry.tmpl_regs, rng), ms, iterations


def timed_train_step(step, ts, carry, key_):
    """One train step with a CUDA event at the end of each piece: (train
    state, carry, ms per piece)."""
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(piece):
        events.append((piece, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    ts, carry, _ = step(ts, carry, key_, mark=mark)
    torch.cuda.synchronize()
    if tuple(p for p, _ in events[1:]) != TRAIN_PIECES:
        raise RuntimeError(f"the train step marked {[p for p, _ in events[1:]]}, expected {TRAIN_PIECES}")
    ms = {p: a.elapsed_time(b) for (_, a), (p, b) in zip(events, events[1:])}
    return ts, carry, ms


def _static_mode(env) -> str:
    """Regen where the layout is static (template auto-reset is exact),
    else cached: the modes of the single-pass step."""
    return "regen" if fr._regen_is_static(env) else "cached"


def main_train(dev, card, env_id: str = ENV_ID, batch: int = TRAIN_BATCH) -> int:
    env = make(env_id)
    mode = _static_mode(env)
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), batch)[0], mode)
    ts = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    step = tr.build_fused_train_step(env, NUM_STEPS, mode=mode)
    keys = iter([key(100 + i, device=dev) for i in range(WARMUP + 2 * CALLS + 1)])
    for _ in range(WARMUP):
        ts, carry, _ = step(ts, carry, next(keys))
    totals = dict.fromkeys(TRAIN_PIECES, 0.0)
    for _ in range(CALLS):
        ts, carry, ms = timed_train_step(step, ts, carry, next(keys))
        for p in TRAIN_PIECES:
            totals[p] += ms[p]
    pieces_ms = {p: totals[p] / CALLS for p in TRAIN_PIECES}

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        ts, carry, _ = step(ts, carry, next(keys))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / CALLS

    whole = sum(pieces_ms.values())
    for p in TRAIN_PIECES:
        print(f"{p:9s} {pieces_ms[p]:.4f} ms/step ({100 * pieces_ms[p] / whole:.1f}%)", flush=True)
    print(f"pieces sum {whole:.4f} ms/step; whole train step {step_ms:.4f} ms/step "
          f"({batch * NUM_STEPS / step_ms * 1e3:.6e} env-steps/s), {env_id} {mode} [{card}]", flush=True)

    kernel_ms, device_ms = profile_one(lambda: step(ts, carry, next(keys)),
                                       ("policy_kernel", "grad_g1_kernel", "grad_g2_kernel"))
    print(json.dumps({
        "card": card, "env_id": env_id, "mode": mode, "train": True, "batch_size": batch, "num_steps": NUM_STEPS,
        "pieces_ms": pieces_ms, "step_ms": step_ms, "profiler_device_ms": device_ms, "profiler_kernel_ms": kernel_ms,
    }), flush=True)
    return 0


def timed_marks(call):
    """`call(mark)` with a CUDA event at each mark: (its result, ms summed
    per piece name)."""
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(piece):
        events.append((piece, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    out = call(mark)
    torch.cuda.synchronize()
    ms = {}
    for (_, a), (p, b) in zip(events, events[1:]):
        ms[p] = ms.get(p, 0.0) + a.elapsed_time(b)
    return out, ms


def _regen_counts():
    return {
        "rollout_kernel": fr.rollout_kernel_launches,
        "policy_kernel": pr.policy_kernel_launches,
        "connect_kernel": gk.connect_kernel_launches,
        "mr_chain_kernel": gk.mr_chain_kernel_launches,
        "host_syncs": cr.host_syncs,
        "reentry_passes": cr.reentry_passes,
        "reentry_lanes": cr.reentry_lanes,
        "grad_kernel": grk.grad_kernel_launches,
    }


def main_train_regen(dev, card, env_id: str, num_steps: int, chunk: int, batch: int = REGEN_BATCH) -> int:
    env = make(env_id)
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), batch)[0], "regen")
    ts = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    step = tr.build_fused_train_step(env, num_steps, mode="regen", regen_chunk=chunk)
    seeds = iter(range(100, 10**6))
    window = max(3, -(-env.config.max_steps // num_steps))
    ts, carry, _ = step(ts, carry, key(next(seeds), device=dev))  # warm-up
    torch.cuda.synchronize()
    counts0 = _regen_counts()
    totals = dict.fromkeys(TRAIN_REGEN_PIECES, 0.0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(window):
        (ts, carry, _), ms = timed_marks(lambda mark: step(ts, carry, key(next(seeds), device=dev), mark=mark))
        for p in TRAIN_REGEN_PIECES:
            totals[p] += ms.get(p, 0.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / window
    per_call = {n: (c - counts0[n]) / window for n, c in _regen_counts().items()}
    pieces_ms = {p: totals[p] / window for p in TRAIN_REGEN_PIECES}
    whole = sum(pieces_ms.values())
    for p in TRAIN_REGEN_PIECES:
        print(f"{p:9s} {pieces_ms[p]:.4f} ms/step ({100 * pieces_ms[p] / whole:.1f}%)", flush=True)
    print(f"pieces sum {whole:.4f} ms/step; whole train step {step_ms:.4f} ms/step "
          f"({batch * num_steps / step_ms * 1e3:.6e} env-steps/s), {window}-step window, {env_id} "
          f"T={num_steps} regen_chunk {chunk}; per step {per_call} [{card}]", flush=True)

    def run_window():
        nonlocal ts, carry
        for _ in range(window):
            ts, carry, _ = step(ts, carry, key(next(seeds), device=dev))

    kernel_ms, device_ms = profile_one(run_window, REGEN_KERNELS + ("grad_g1_kernel", "grad_g2_kernel"))
    print(json.dumps({
        "card": card, "env_id": env_id, "train": True, "regen_chunk": chunk, "batch_size": batch,
        "num_steps": num_steps, "window_steps": window, "pieces_ms": pieces_ms, "step_ms": step_ms,
        "per_step": per_call, "profiler_window_device_ms": device_ms, "profiler_window_kernel_ms": kernel_ms,
    }), flush=True)
    return 0


def main_regen(dev, card, env_id: str, num_steps: int, chunk: int, policy: bool, batch: int = REGEN_BATCH) -> int:
    env = make(env_id)
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), batch)[0], "regen")
    if policy:
        model = ActorCritic(env.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        step = pr.build_policy_eval_rollout(env, model, num_steps, mode="regen", as_carry=True, regen_chunk=chunk)
        seeds = iter(range(100, 10**6))
        source = lambda: key(next(seeds), device=dev)  # noqa: E731
    else:
        step = fr.build_fused_rollout(env, num_steps, mode="regen", as_carry=True, regen_chunk=chunk)
        gen = torch.Generator(device=dev).manual_seed(1)
        source = lambda: gen  # noqa: E731
    window = max(3, -(-env.config.max_steps // num_steps))
    carry, _ = step(source(), carry)  # warm-up
    torch.cuda.synchronize()
    counts0 = _regen_counts()
    totals = dict.fromkeys(REGEN_PIECES, 0.0)
    episodes = overlaps = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(window):
        (carry, metrics), ms = timed_marks(lambda mark: step(source(), carry, mark=mark))
        for p in REGEN_PIECES:
            totals[p] += ms[p]
        episodes += int(metrics.episodes)
        overlaps += int(metrics.reset_overlaps)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / window
    per_call = {n: (c - counts0[n]) / window for n, c in _regen_counts().items()}
    pieces_ms = {p: totals[p] / window for p in REGEN_PIECES}
    whole = sum(pieces_ms.values())
    for p in REGEN_PIECES:
        print(f"{p:8s} {pieces_ms[p]:.4f} ms/call ({100 * pieces_ms[p] / whole:.1f}%)", flush=True)
    print(f"pieces sum {whole:.4f} ms/call; whole step call {step_ms:.4f} ms/call "
          f"({batch * num_steps / step_ms * 1e3:.6e} env-steps/s), {window}-call window, {env_id} "
          f"T={num_steps} regen_chunk {chunk}{' policy' if policy else ''}: episodes {episodes}, reset_overlaps "
          f"{overlaps}; per call {per_call} [{card}]", flush=True)

    def run_window():
        nonlocal carry
        for _ in range(window):
            carry, _ = step(source(), carry)

    kernel_ms, device_ms = profile_one(run_window, REGEN_KERNELS)
    print(json.dumps({
        "card": card, "env_id": env_id, "policy": policy, "regen_chunk": chunk, "batch_size": batch,
        "num_steps": num_steps, "window_calls": window, "pieces_ms": pieces_ms, "step_ms": step_ms,
        "per_call": per_call, "episodes": episodes, "reset_overlaps": overlaps,
        "profiler_window_device_ms": device_ms, "profiler_window_kernel_ms": kernel_ms,
    }), flush=True)
    return 0


def profile_one(fn, kernel_names):
    """`fn()` under `torch.profiler`: prints the device-time table and
    returns ({kernel name: device ms}, all device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="device_time_total", row_limit=15), flush=True)
    # Device-side events only, as the table's "Self CUDA time total" sums
    # them: an op's self device time repeats that of the kernels it ran.
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernel_ms = {n: sum(e.self_device_time_total for e in device if n in e.key) / 1e3 for n in kernel_names}
    return kernel_ms, sum(e.self_device_time_total for e in device) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step_torch: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    if "--train" in args and "--regen" in args:
        return main_train_regen(dev, card, opt("--env", REGEN_ENV_ID), int(opt("--steps", NUM_STEPS)),
                                int(opt("--chunk", 32)), int(opt("--batch", REGEN_BATCH)))
    if "--train" in args:
        return main_train(dev, card, opt("--env", ENV_ID), int(opt("--batch", TRAIN_BATCH)))
    policy = "--policy" in args
    if "--regen" in args:
        return main_regen(dev, card, opt("--env", REGEN_ENV_ID), int(opt("--steps", NUM_STEPS)),
                          int(opt("--chunk", 128)), policy, int(opt("--batch", REGEN_BATCH)))
    env_id, batch = opt("--env", ENV_ID), int(opt("--batch", BATCH))
    env = make(env_id)
    mode = _static_mode(env)
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), batch)[0], mode)
    if policy:
        model = ActorCritic(env.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        weights = pr.eval_weights_from_params(model, env.config.agent_view_size)
        step = pr.build_policy_eval_rollout(env, model, NUM_STEPS, mode=mode, as_carry=True)
        sources = iter([key(100 + i, device=dev) for i in range(WARMUP + 2 * CALLS + 1)])
        stream_fn = lambda k, b, d: pr._seeds_for(k, NUM_STEPS, b)
        run_core = lambda *a: pr.run_policy_kernel(*a[:5], weights, a[5], transition=env.transition)
        kernel_name = "policy_kernel"
    else:
        step = fr.build_fused_rollout(env, NUM_STEPS, mode=mode, as_carry=True)
        gen = torch.Generator(device=dev).manual_seed(1)
        sources = iter(lambda: gen, None)
        stream_fn = lambda g, b, d: fr._action_stream(env, NUM_STEPS, g, b, d)
        run_core = lambda *a: fr.run_rollout_kernel(*a, transition=env.transition)
        kernel_name = "rollout_kernel"

    for _ in range(WARMUP):
        carry, _ = step(next(sources), carry)
    totals = dict.fromkeys(PIECES, 0.0)
    iterations = 0
    for _ in range(CALLS):
        carry, ms, it = timed_pieces(env, NUM_STEPS, next(sources), carry, stream_fn, run_core, mode)
        iterations += it
        for p in PIECES:
            totals[p] += ms[p]
    pieces_ms = {p: totals[p] / CALLS for p in PIECES}

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        carry, _ = step(next(sources), carry)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / CALLS

    whole = sum(pieces_ms.values())
    for p in PIECES:
        print(f"{p:8s} {pieces_ms[p]:.4f} ms/call ({100 * pieces_ms[p] / whole:.1f}%)", flush=True)
    print(f"pieces sum {whole:.4f} ms/call; whole step call {step_ms:.4f} ms/call "
          f"({batch * NUM_STEPS / step_ms * 1e3:.6e} env-steps/s), {env_id} {mode}; "
          f"replay {iterations / CALLS:.2f} iterations/call [{card}]", flush=True)

    kernel_ms, device_ms = profile_one(lambda: step(next(sources), carry), (kernel_name,))
    print(json.dumps({
        "card": card, "env_id": env_id, "mode": mode, "policy": policy, "batch_size": batch, "num_steps": NUM_STEPS,
        "pieces_ms": pieces_ms, "step_ms": step_ms, "replay_iterations_per_call": iterations / CALLS,
        "profiler_device_ms": device_ms, "profiler_kernel_ms": kernel_ms[kernel_name],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
