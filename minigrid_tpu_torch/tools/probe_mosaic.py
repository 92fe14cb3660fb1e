"""The Mosaic bisection probe on a CUDA card (counterpart of the JAX
package's `tools/probe_mosaic.py`).

The JAX tool isolates the dW2 product of the gradient kernel's G2: the
actor's forward on one-hot features, a relu-masked cotangent in nine
formulations, and an f32 `(256, 256)` accumulator `acc = Σ dh·h1ᵀ` over
two 512-lane blocks. On the TPU it bisected a compiler crash, one
subprocess per variant. That crash is the TPU compiler's, so here every
variant runs in one process, in CUDA kernels templated on the variant
(`ops/csrc/probe_mosaic.cu`: the forward once per lane, then the product,
both on `wgmma`), beside its plain version `plain_probe`; the probe checks
G2's masked product instead:

  * the variants whose formula is the same (`SAME_FORMULA`: they all mask
    the bf16 `h2p` at `> 0` and cast `g` to bf16) agree bit for bit;
  * `mask_from_f32`, `f32_dot` and `control_unmasked` stay within an
    elementwise bound of `base_where` (`deviation_bound`);
  * each kernel agrees with its plain version, and two runs bit for bit.

    python -m minigrid_tpu_torch.tools.probe_mosaic            # the table
    python -m minigrid_tpu_torch.tools.probe_mosaic <variant>  # one variant

Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from minigrid_tpu_torch.ops.grad_kernel import _feats
from minigrid_tpu_torch.ops.policy_rollout import _b_chunks, _bf16_bias

F = 980  # feature rows (V²·20 at V = 7)
H = 256
BT = 512  # lanes of one block (the TPU grid step)
V2 = 49
STEPS = 2  # the TPU grid

VARIANTS = [
    "control_unmasked",  # no mask: the bisection's control
    "base_where",  # dh = where(h2p > 0, bf16(g), 0)
    "bitand_mask",  # the mask as an and on the bits of bf16(g)
    "int_select_bitcast",  # a select on the bits, then a bitcast
    "scratch_roundtrip",  # base_where's dh through a bf16 scratch
    "f32_dot",  # the masked cotangent in f32, the product in f32
    "opt_barrier",  # base_where (an optimization barrier has no CUDA meaning)
    "mask_from_f32",  # the mask on the pre-cast f32 h2d + b2
    "upcast_cmp",  # mask f32(h2p) > 0, the same value as base_where's
]
SAME_FORMULA = ("base_where", "bitand_mask", "int_select_bitcast", "scratch_roundtrip", "opt_barrier", "upcast_cmp")
INPUT_NAMES = ("obs", "g", "wt1", "b1", "wt2", "b2")
# The kernel against `plain_probe` under the probe's normal draws, as a
# share of the largest |acc|: the two sum layer 1 and layer 2 in other
# orders, so a bf16 rounding of h1 or the sign of an h2p near zero can
# flip, which moves one term of about |g|·|h1| (about 1 against a largest
# |acc| of about 460). Under dyadic inputs they agree bit for bit.
NORMAL_REL_TOL = 1e-2

# Launches of the CUDA probe kernel in this process (plain integer; the
# wrapper adds one per launch and nowhere else).
probe_kernel_launches = 0


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), kept as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _sparse_dyadic(rng, rows, cols, nnz, scale):
    w = np.zeros((rows, cols), np.float32)
    for r in range(rows):
        idx = rng.choice(cols, size=nnz, replace=False)
        w[r, idx] = rng.integers(1, 5, size=nnz) * rng.choice([-1, 1], size=nnz) * scale
    return w


def probe_inputs(seed: int = 0, dyadic: bool = False) -> dict:
    """The probe's inputs as numpy arrays (`obs` int32, the rest f32 with
    the weights' values exact in bf16). By default drawn as the JAX tool
    draws them: obs words in `[0, 2^11)`, `g` standard normal, the weights
    normal (`wt1`, `wt2` times 0.05). With `dyadic`, sparse weights and a
    cotangent on grids of quarters, under which every f32 sum of the
    probe is exact in any order, so all implementations agree bit for
    bit."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 1 << 11, (STEPS, V2, BT)).astype(np.int32)
    if dyadic:
        g = rng.integers(-4, 5, (H, BT)).astype(np.float32) * 0.25
        wt1 = _sparse_dyadic(rng, H, F, 4, 0.25)
        wt2 = _sparse_dyadic(rng, H, H, 4, 0.25)
        b1, b2 = (rng.integers(-2, 3, (H, 1)).astype(np.float32) * 0.25 for _ in range(2))
    else:
        g = rng.standard_normal((H, BT)).astype(np.float32)
        wt1 = _bf16_exact(rng.standard_normal((H, F)).astype(np.float32)) * np.float32(0.05)
        b1 = rng.standard_normal((H, 1)).astype(np.float32)
        wt2 = _bf16_exact(rng.standard_normal((H, H)).astype(np.float32)) * np.float32(0.05)
        b2 = rng.standard_normal((H, 1)).astype(np.float32)
    return {"obs": obs, "g": g, "wt1": _bf16_exact(wt1), "b1": _bf16_exact(b1), "wt2": _bf16_exact(wt2),
            "b2": _bf16_exact(b2)}


def to_tensors(inputs: dict, device) -> tuple:
    """`probe_inputs` as the kernel takes them on `device`: obs int32, g
    f32, the weights bf16."""
    out = []
    for name in INPUT_NAMES:
        t = torch.from_numpy(inputs[name]).to(device)
        out.append(t.to(torch.bfloat16) if name not in ("obs", "g") else t)
    return tuple(out)


def _forward(obs_j, wt1, b1, wt2, b2):
    """One block's forward: (h1 bf16, h2d f32, h2p bf16)."""
    h1 = torch.relu(_bf16_bias(wt1.float() @ _feats(obs_j), b1))
    h2d = wt2.float() @ h1.float()
    return h1, h2d, _bf16_bias(h2d, b2)


def _cotangent(variant: str, g, h2d, h2p, b2):
    """The variant's masked cotangent `dh` (f32 for `f32_dot`, else bf16)."""
    gb = g.to(torch.bfloat16)
    zero = torch.zeros_like(gb)
    if variant == "control_unmasked":
        return gb
    if variant == "f32_dot":
        return torch.where(h2p > 0, g, torch.zeros_like(g))
    if variant == "mask_from_f32":
        return torch.where(h2d + b2.float() > 0, g, torch.zeros_like(g)).to(torch.bfloat16)
    if variant == "bitand_mask":
        bits = gb.view(torch.int16) & -(h2p > 0).to(torch.int16)
        return bits.view(torch.bfloat16)
    if variant == "int_select_bitcast":
        return torch.where(h2p > 0, gb.view(torch.int16), zero.view(torch.int16)).view(torch.bfloat16)
    if variant == "upcast_cmp":
        return torch.where(h2p.float() > 0, g, torch.zeros_like(g)).to(torch.bfloat16)
    if variant in ("base_where", "scratch_roundtrip", "opt_barrier"):
        return torch.where(h2p > 0, gb, zero)
    raise ValueError(f"unknown probe variant {variant!r}")


def plain_probe(variant: str, obs, g, wt1, b1, wt2, b2) -> torch.Tensor:
    """The probe's `(256, 256)` f32 accumulator as torch ops, on any
    device: per block the forward, the variant's `dh` and `dh·h1ᵀ` (f32
    products of the bf16 values; full f32 for `f32_dot`), summed over the
    blocks in order."""
    acc = torch.zeros((H, H), dtype=torch.float32, device=g.device)
    for j in range(obs.shape[0]):
        h1, h2d, h2p = _forward(obs[j], wt1, b1, wt2, b2)
        acc = acc + _cotangent(variant, g, h2d, h2p, b2).float() @ h1.float().T
    return acc


def deviation_bound(variant: str, obs, g, wt1, b1, wt2, b2) -> torch.Tensor:
    """An elementwise bound on `|acc(variant) - acc(base_where)|`: the
    terms where the variant's `dh` may differ from base_where's, in
    absolute value (where the masks differ, `|bf16(g)|`; for `f32_dot`,
    the bf16 rounding of `g`, at most `2^-8 |g|`), plus `2^-12` of the sum
    of all terms' magnitudes for two f32 sums of 1024 terms in other
    orders. It holds between two results of `plain_probe`."""
    bound = torch.zeros((H, H), dtype=torch.float32, device=g.device)
    gabs, gbabs = g.abs(), g.to(torch.bfloat16).float().abs()
    for j in range(obs.shape[0]):
        h1, h2d, h2p = _forward(obs[j], wt1, b1, wt2, b2)
        h1a = h1.float().abs()
        if variant == "control_unmasked":
            differ = gbabs * (h2p <= 0)
        elif variant == "mask_from_f32":
            differ = gbabs * ((h2d + b2.float() > 0) != (h2p > 0))
        elif variant == "f32_dot":
            differ = 2.0**-8 * gabs * (h2p > 0)
        else:
            differ = torch.zeros_like(gabs)
        bound = bound + differ @ h1a.T + 2.0**-12 * (gabs @ h1a.T)
    return bound


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"probe kernel: {name} must be contiguous {dtype}{shape}, got {t.dtype}{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"probe kernel: {name} is on {t.device}, obs on {device}")


def probe_weight_chunks(wt1, wt2) -> tuple:
    """`wt1` `(256, 980)` and `wt2` `(256, 256)` as the probe kernel's
    weight ring streams them (`_b_chunks`: W1ᵀ's K chunks outer, both N
    halves of a chunk together; W2ᵀ one N half at a time), on their
    device."""
    return _b_chunks(wt1, True), _b_chunks(wt2, False)


def run_probe_kernel(variant: str, obs, g, wt1, b1, wt2, b2) -> torch.Tensor:
    """The probe kernel's wrapper: same arguments and result as
    `plain_probe`, at the probe's shapes (obs `(2, 49, 512)` int32, g
    `(256, 512)` f32, wt1 `(256, 980)`, b1 `(256, 1)`, wt2 `(256, 256)`,
    b2 `(256, 1)` bf16). CPU tensors run `plain_probe`; CUDA tensors
    launch the kernels on the current stream (the forward, then the
    product), and anything else raises. The weights' chunk layout
    (`probe_weight_chunks`) is made on the card in every call."""
    if obs.device.type == "cpu":
        return plain_probe(variant, obs, g, wt1, b1, wt2, b2)
    if obs.device.type != "cuda":
        raise ValueError(f"probe kernel: obs is on {obs.device}, expected a CUDA device")
    vid = VARIANTS.index(variant)
    dev = obs.device
    for name, t, shape, dtype in (
        ("obs", obs, (STEPS, V2, BT), torch.int32), ("g", g, (H, BT), torch.float32),
        ("wt1", wt1, (H, F), torch.bfloat16), ("b1", b1, (H, 1), torch.bfloat16),
        ("wt2", wt2, (H, H), torch.bfloat16), ("b2", b2, (H, 1), torch.bfloat16),
    ):
        _check(name, t, shape, dtype, dev)
    from minigrid_tpu_torch.ops import _build

    lib = _build.load_library(dev)
    w1s, w2s = probe_weight_chunks(wt1, wt2)
    h1 = torch.empty((H, STEPS * BT), dtype=torch.bfloat16, device=dev)
    dh = torch.empty((H, STEPS * BT), dtype=torch.float32 if variant == "f32_dot" else torch.bfloat16, device=dev)
    out = torch.empty((H, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_mosaic_probe_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (obs, g, w1s, b1, w2s, b2, h1, dh, out)), vid,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})")
    global probe_kernel_launches
    probe_kernel_launches += 1
    return out


def run_variant(variant: str, device="cuda", seed: int = 0) -> torch.Tensor:
    """One variant on the probe's own normal draws: the kernel for a CUDA
    `device`, the plain version on the CPU. Prints the result's norm, as
    the JAX tool does, and returns the accumulator."""
    out = run_probe_kernel(variant, *to_tensors(probe_inputs(seed), device))
    print(f"OK {variant}: out_norm={float(torch.linalg.norm(out)):.3f}", flush=True)
    return out


def _time_ms(fn, reps: int) -> tuple:
    """(ms per call over `reps` calls after one warm-up, by CUDA events; the last result)."""
    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_ms(variant: str, args: tuple, reps: int) -> tuple:
    """Device time per call of `run_probe_kernel(variant, *args)` over
    `reps` calls under `torch.profiler`: (the probe's own kernels, the
    forward and the product; every kernel of the call, the weights' chunk
    layout included), or (None, None) where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    run_probe_kernel(variant, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_probe_kernel(variant, *args)
        torch.cuda.synchronize()
    probe_us = call_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        call_us += us
        if "probe_" in e.key:
            probe_us += us
    if not probe_us:
        return None, None
    return probe_us / reps / 1e3, call_us / reps / 1e3


def table(device="cuda", seed: int = 0, reps: int = 20) -> dict:
    """Every variant on the card, under dyadic inputs and under the probe's
    normal draws: the kernel against `plain_probe` (bit for bit under
    dyadic inputs; under normal draws the largest difference over the
    largest `|acc|`), two kernel runs bit for bit, the kernel's and the
    plain version's time (CUDA events, mean of `reps` after a warm-up),
    the kernels' and the whole call's device time (`device_ms`),
    the agreement of `SAME_FORMULA` and each other variant's deviation
    from `base_where`. That deviation's bound on the card is
    `deviation_bound` (between the plain results) plus twice
    `NORMAL_REL_TOL` of the largest |acc| (each kernel's allowance against
    its plain result). Returns the rows and raises on any failed check."""
    dev = torch.device(device)
    dyadic = to_tensors(probe_inputs(seed, dyadic=True), dev)
    normal = to_tensors(probe_inputs(seed), dev)
    rows, kernel_out, base_plain = {}, {}, None
    for v in VARIANTS:
        exact = run_probe_kernel(v, *dyadic)
        exact_plain = plain_probe(v, *dyadic)
        ms, out = _time_ms(lambda: run_probe_kernel(v, *normal), reps)
        plain_ms, want = _time_ms(lambda: plain_probe(v, *normal), reps)
        again = run_probe_kernel(v, *normal)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        kernels_ms, call_ms = device_ms(v, normal, reps)
        rows[v] = {
            "ms": ms, "plain_ms": plain_ms, "device_ms": kernels_ms, "call_device_ms": call_ms,
            "dyadic_equal": bool(torch.equal(exact, exact_plain)),
            "max_abs_err": err, "rel_err": err / float(want.abs().max()),
            "repeat_bitwise": bool(torch.equal(out.view(torch.int32), again.view(torch.int32))),
        }
        kernel_out[v] = out
        if v == "base_where":
            base_plain = want
    base = kernel_out["base_where"]
    for v in VARIANTS:
        if v in SAME_FORMULA:
            rows[v]["same_as_base_where"] = bool(torch.equal(kernel_out[v].view(torch.int32), base.view(torch.int32)))
        else:
            dev_v = (kernel_out[v] - base).abs()
            bnd = deviation_bound(v, *normal) + 2 * NORMAL_REL_TOL * float(base_plain.abs().max())
            rows[v]["deviation_from_base_where"] = float(dev_v.max())
            rows[v]["deviation_over_bound"] = float((dev_v / torch.clamp(bnd, min=1e-30)).max())
    for v, r in rows.items():
        print(f"{v:20s} kernel {r['ms']:.6f} ms through its wrapper (device time: its kernels {r['device_ms']} ms, "
              f"the whole call {r['call_device_ms']} ms), plain {r['plain_ms']:.6f} ms; "
              f"dyadic equal {r['dyadic_equal']}; "
              f"normal max err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}); repeat bitwise "
              f"{r['repeat_bitwise']}; " + (f"same as base_where {r['same_as_base_where']}" if v in SAME_FORMULA
                                            else f"deviation from base_where {r['deviation_from_base_where']:.6e} "
                                                 f"({r['deviation_over_bound']:.4f} of its bound)"), flush=True)
    bad = [v for v, r in rows.items() if not (r["dyadic_equal"] and r["repeat_bitwise"]
                                              and r["rel_err"] <= NORMAL_REL_TOL
                                              and r.get("same_as_base_where", True)
                                              and r.get("deviation_over_bound", 0.0) <= 1.0)]
    if bad:
        raise RuntimeError(f"probe variants failed their checks: {bad}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mosaic: needs a CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        run_variant(sys.argv[1])
        return 0
    print(json.dumps(table()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
