"""Build and bind the port's CUDA kernels.

The sources under `csrc/` are compiled with `nvcc` (one process per
`.cu`, in parallel) into a shared library with a plain C interface, at
first use, into `build/minigrid_tpu_torch/` beside the package, keyed by a
hash of the sources and flags; `ctypes` loads it. Nothing here runs at
import, and nothing is compiled on a machine without a CUDA device: the
wrappers only call `load_library` for tensors on one.

Loading also checks the device, once per device and process: the library
is built for `sm_90a` (Hopper), so any other card raises; then the probe
kernel (`probe`, `x + 1` on an `(8, 128)` int32 block, the counterpart of
the JAX package's Mosaic capability probe in `utils/platform.py`) is
launched and its result checked, so a library the card cannot run fails
here and not inside a rollout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "minigrid_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PROBE_SHAPE = (8, 128)

_lib = None
_checked_devices = set()
# Launches of the probe kernel in this process (plain integer; `probe`
# adds one per launch and nowhere else).
probe_launches = 0
# What the last build in this process did: seconds and the compiler's
# report (registers, shared memory, spills). None when the library came
# from the build cache.
last_build_seconds = None
last_build_log = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"minigrid_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the cached library is missing; return its path.
    Each `.cu` compiles in its own nvcc process, all started together, so
    the build takes as long as its longest file; then one more links them."""
    global last_build_seconds, last_build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    cmds.append([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds[:-1]]
    logs = [p.communicate()[0] for p in procs]
    if all(p.returncode == 0 for p in procs):
        res = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(res)
        logs.append(res.stdout)
    for o in objs:
        o.unlink(missing_ok=True)
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{log}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "".join(logs)
    return out


def _check_capability(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); {device} is "
            f"{torch.cuda.get_device_name(device)} with compute capability {cap}"
        )


def _open() -> ctypes.CDLL:
    """Build (if needed) and dlopen the library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr = ctypes.c_void_p
        lib.mg_rollout_launch.argtypes = [ptr] * 12 + [ctypes.c_int] * 14 + [ptr]
        lib.mg_rollout_launch.restype = ctypes.c_int
        lib.mg_rollout_occupancy.argtypes = [ctypes.c_int] * 7
        lib.mg_rollout_occupancy.restype = ctypes.c_int
        lib.mg_policy_launch.argtypes = [ptr] * 19 + [ctypes.c_int] * 15 + [ptr]
        lib.mg_policy_launch.restype = ctypes.c_int
        lib.mg_grad_launch.argtypes = (
            [ptr] * 17 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3 + [ctypes.c_int, ptr]
        )
        lib.mg_grad_launch.restype = ctypes.c_int
        lib.mg_connect_launch.argtypes = [ptr] * 8 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [ptr]
        lib.mg_connect_launch.restype = ctypes.c_int
        lib.mg_mr_chain_launch.argtypes = [ptr] * 6 + [ctypes.c_int] * 6 + [ptr]
        lib.mg_mr_chain_launch.restype = ctypes.c_int
        lib.mg_gen_occupancy.argtypes = [ctypes.c_int]
        lib.mg_gen_occupancy.restype = ctypes.c_int
        lib.mg_mosaic_probe_launch.argtypes = [ptr] * 9 + [ctypes.c_int, ptr]
        lib.mg_mosaic_probe_launch.restype = ctypes.c_int
        lib.mg_probe_launch.argtypes = [ptr, ptr, ctypes.c_int, ptr]
        lib.mg_probe_launch.restype = ctypes.c_int
        lib.mg_error_string.argtypes = [ctypes.c_int]
        lib.mg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def probe(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's wrapper: `x + 1` on a contiguous int32 tensor.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, and anything else raises."""
    if x.device.type == "cpu":
        return x + 1
    if x.device.type != "cuda":
        raise ValueError(f"probe kernel: x is on {x.device}, expected a CUDA device")
    if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"probe kernel: x must be non-empty contiguous int32, got {x.dtype}{tuple(x.shape)}")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if index not in _checked_devices:  # a device that passed load_library is a Hopper card
        _check_capability(x.device)
    lib = _open()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mg_probe_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), x.numel(),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})")
    global probe_launches
    probe_launches += 1
    return out


def load_library(device: torch.device) -> ctypes.CDLL:
    """The kernels' library, built and loaded once per process. The first
    call for each device checks that it is a Hopper card and that the
    probe kernel launches on it and computes `x + 1`; either failure
    raises."""
    _check_capability(device)
    lib = _open()
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _checked_devices:
        x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.int32, device=device)
        x = x.reshape(PROBE_SHAPE)
        if not torch.equal(probe(x), x + 1):
            raise RuntimeError(f"probe kernel on {device} did not compute x + 1")
        _checked_devices.add(index)
    return lib
