#!/usr/bin/env python3
"""Where a rollout-kernel (B1) lane-step's cycles go, from `clock64` reads
inside the kernel.

    python3 tools/b1_cycle_split.py [--src DIR]

Builds a patched copy of the rollout kernel's sources in `DIR` (default:
the port's `ops/csrc`) under `build/b1_cycle_split/`: `clock64` reads
around the pieces of the T loop (the action load, the transition, the view
read with the flood and the checksum, and the rest of the loop), each
thread of block 0 writing its sums. It builds that copy alone with nvcc
(one translation unit, against the headers in `DIR`) and runs it through
the port's wrapper `run_rollout_kernel` at three shapes: Empty-8x8 (B =
2^21, see-through walls), KeyCorridorS6R3 (B = 32,768, occlusion, the
pickup-target hook and the commit rows) and DynamicObstacles-16x16 (B =
262,144, the walk), each from `reset_batch(key(0))` in cached mode under
random actions. It prints, for the threads of block 0, the mean cycles per
lane-step of each piece and its share. The reads themselves cost cycles and
fence the pieces, so the split is a guide, not a time. The sources in the
tree are not changed. Needs a CUDA card.

It knows two layouts of the sources: this tree's (`rollout_kernel.cuh`:
the 16-bit kernel's loop is patched; the generic kernel, which the plans
here do not pick, is not), and the one-file kernel of earlier trees
(`rollout_kernel.cu` alone, with that tree's wrapper: copy this file into
that tree's `tools/` and run it there).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PIECES = ("action", "step", "view", "rest")
# (env id, B, T, commit rows)
CASES = (
    ("MiniGrid-Empty-8x8-v0", 2_097_152, 64, False),
    ("MiniGrid-KeyCorridorS6R3-v0", 32_768, 128, True),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", 262_144, 32, False),
)

CYCLES = "__device__ long long g_cycles[5 * 1024];\n\n"
READER = ("extern \"C\" int mg_cycles_read(void* out) {\n"
          "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles)));\n}\n")
STORE = ("  if (blockIdx.x == 0) {\n    for (int k = 0; k < 4; ++k) g_cycles[tid * 5 + k] = cyc[k];\n"
         "    g_cycles[tid * 5 + 4] = p.T;\n  }\n")
START = ("  long long cyc[4] = {0, 0, 0, 0};\n  long long c_end = clock64();\n"
         "  for (int t = 0; t < p.T; ++t) {\n    long long c0 = clock64();\n    cyc[3] += c0 - c_end;\n"
         "    int a = p.actions[t * B + lane];\n    asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(a));\n"
         "    long long c1 = clock64();\n    cyc[0] += c1 - c0;\n")
STEP_END = "    long long c2 = clock64();\n    cyc[1] += c2 - c1;\n"
VIEW_END = ("    asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(checksum));\n"
            "    c_end = clock64();\n    cyc[2] += c_end - c2;\n  }\n")

# The 16-bit kernel's loop in rollout_kernel.cuh: text -> the same with the
# reads. Each anchor must occur once.
PATCHES_CUH = (
    ("  for (int t = 0; t < p.T; ++t) {\n    const int a = p.actions[t * B + lane];\n    bool done;\n"
     "    float reward;\n    if (!step_lane_grid",
     START + "    bool done;\n    float reward;\n    if (!step_lane_grid"),
    ("                                     reward, done))\n      break;\n",
     "                                     reward, done))\n      break;\n" + STEP_END),
    ("    checksum += view_checksum16<kView, kTpl>(grid, sh, s);\n  }\n",
     "    checksum += view_checksum16<kView, kTpl>(grid, sh, s);\n" + VIEW_END + STORE),
    ("namespace mg_rollout {\n\nstruct Params {", CYCLES + "namespace mg_rollout {\n\nstruct Params {"),
)
# The one-file kernel of earlier trees (rollout_kernel.cu).
PATCHES_CU = (
    ("  for (int t = 0; t < p.T; ++t) {\n    const int a = p.actions[t * B + lane];\n", START),
    ("      break;\n", "      break;\n" + STEP_END),
    ("    checksum += obs_sum;\n  }\n", "    checksum += obs_sum;\n" + VIEW_END + STORE),
    ("namespace {\n\nstruct Params {", CYCLES + "namespace {\n\nstruct Params {"),
)


def _patch(text: str, patches, name: str) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in {name}: {old!r}")
        text = text.replace(old, new)
    return text


def patched_library(src: Path) -> tuple:
    """(the patched library's path, True for this tree's layout): one
    translation unit, the header inlined where the sources include it."""
    from minigrid_tpu_torch.ops import _build

    header = src / "rollout_kernel.cuh"
    if header.exists():
        inc = '#include "rollout_kernel.cuh"\n'
        body = _patch(header.read_text(), PATCHES_CUH, header.name)
        text = (src / "rollout_kernel.cu").read_text().replace(inc, body)
        for extra in sorted(src.glob("rollout_cells16_*.cu")):
            text += "\n" + extra.read_text().replace(inc, "")
    else:
        text = _patch((src / "rollout_kernel.cu").read_text(), PATCHES_CU, "rollout_kernel.cu")
    text += "\n" + READER
    out_dir = REPO / "build" / "b1_cycle_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "rollout_kernel_cycles.cu"
    cu.write_text(text)
    lib = out_dir / "rollout_cycles.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(lib), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return lib, header.exists()


def bind(path: Path, dev, current: bool):
    """Load the patched library in place of the port's, so that the wrapper
    launches it (the port's own library already passed the launch check on
    `dev` while the states were generated)."""
    import torch

    from minigrid_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    if current:
        lib.mg_rollout_launch.argtypes = [ptr] * 12 + [ctypes.c_int] * 14 + [ptr]
        lib.mg_rollout_occupancy.argtypes = [ctypes.c_int] * 7
        lib.mg_rollout_occupancy.restype = ctypes.c_int
    else:
        lib.mg_rollout_launch.argtypes = [ptr] * 12 + [ctypes.c_int] * 11 + [ptr]
    lib.mg_rollout_launch.restype = ctypes.c_int
    lib.mg_error_string.argtypes = [ctypes.c_int]
    lib.mg_error_string.restype = ctypes.c_char_p
    lib.mg_cycles_read.argtypes = [ptr]
    lib.mg_cycles_read.restype = ctypes.c_int
    _build._lib = lib
    _build._checked_devices.add(dev.index if dev.index is not None else torch.cuda.current_device())
    return lib


def case_args(dev, env_id, b, t, ctl):
    """The wrapper's arguments for a case: the packed states of
    `reset_batch(key(0))` (generated through the port's own library), random
    actions, fresh commit rows if `ctl`."""
    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr

    env = make(env_id)
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), b)[0], "cached")
    rng = np.random.default_rng(0)
    actions = torch.from_numpy(rng.integers(0, 7, (t, b)).astype(np.int32)).to(dev)
    ctl_rows = torch.zeros((3, b), dtype=torch.int32, device=dev) if ctl else None
    return (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, actions, env.config, env.transition, ctl_rows)


def run_case(lib, args, env_id, b, t, ctl):
    import numpy as np
    import torch

    from minigrid_tpu_torch.ops import fused_rollout as fr

    fr.run_rollout_kernel(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fr.run_rollout_kernel(*args)
    end.record()
    torch.cuda.synchronize()
    buf = np.zeros(5 * 1024, np.int64)
    err = lib.mg_cycles_read(ctypes.c_void_p(buf.ctypes.data))
    if err != 0:
        raise RuntimeError(f"cudaMemcpyFromSymbol failed: {err}")
    rows = buf.reshape(1024, 5)
    rows = rows[rows[:, 4] > 0]
    per_step = rows[:, :4].mean(axis=0) / t
    total = per_step.sum()
    split = ", ".join(f"{n} {c:.0f} ({100 * c / total:.1f} %)" for n, c in zip(PIECES, per_step))
    plan = getattr(fr, "last_rollout_plan", None)
    print(f"{env_id} B={b} T={t} ctl={ctl} transition={args[6]}: {start.elapsed_time(end):.6f} ms a call "
          f"(instrumented); block 0, {len(rows)} threads, cycles per lane-step: {split}; total {total:.0f}; "
          f"plan {plan}", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=REPO / "minigrid_tpu_torch" / "ops" / "csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_cycle_split: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    path, current = patched_library(args.src.resolve())
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cases = [(case_args(dev, *case), case) for case in CASES]
    if current:  # the card's plans, from the port's own library
        from minigrid_tpu_torch.ops import fused_rollout as fr

        for wrapper_args, _ in cases:
            fr.run_rollout_kernel(*wrapper_args)
        fr._card_plan.cache_clear()
    lib = bind(path, dev, current)
    for wrapper_args, case in cases:
        run_case(lib, wrapper_args, *case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
