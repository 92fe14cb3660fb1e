"""Policy-in-the-loop evaluation: the actor inside the packed rollout, in
one hand-written CUDA kernel, plus its plain twin (counterpart of
`minigrid_tpu/ops/policy_rollout.py`, eval mode).

Each step, every lane runs the `ActorCritic` actor on its pre-step view,
draws an action by inverse CDF from one Threefry uniform of a precomputed
`(T, B)` int32 seed (the key of `step(key, carry)` makes the seeds, as
`jax.random.bits` does), and takes the packed step of
`ops/fused_rollout.py`. Nothing but the carry and the metrics leaves the
call. Which code runs is decided by where the tensors lie: on a CUDA
device `run_policy_kernel` launches `csrc/policy_kernel.cu` (or raises);
on the CPU it runs the plain twin `plain_policy_rollout`.

`policy_logits` mirrors the flax forward on the JAX package's transposed,
value-major weight layout (`EvalWeights`, kept at the public surface so
that tests compare like with like): bf16 operands, f32 sums rounded to
bf16, bf16 bias adds, f32 head. Its f32 GEMMs run in full f32; keep
`torch.backends.cuda.matmul.allow_tf32` off when the twin runs on a card.
Under weights whose f32 sums are exact in any order (a sparse dyadic
grid, `testing.dyadic_flax_params`) the port, the kernel and the JAX
package agree byte for byte; under other weights the summation order can
flip a bf16 rounding, and with it, rarely, a sampled action.

Scope: eval mode, cached auto-reset, and regen on the static-layout
families (Empty, DistShift). Collect mode (the trajectory spill), family
hooks and chunked regen are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from minigrid_tpu_torch.core.prng import default_device, hash_u31, random_bits
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs.base import BASE_STEP, Env
from minigrid_tpu_torch.models.policy import CHANNEL_WIDTHS
from minigrid_tpu_torch.ops.fused_rollout import (
    _MAX_VIEW,
    _SMEM_LIMIT,
    _check_supported,
    _kernel_tables,
    _regen_is_static,
    build_carry_surface,
    obs_core,
    step_core,
)
from minigrid_tpu_torch.ops.packing import NUM_REGS

_F = sum(CHANNEL_WIDTHS)  # 20 features per cell
_SEED_SALT = 0x243F6A88  # second Threefry key word for the sampling stream
HIDDEN = 256  # the kernel's torso width (ActorCritic's only one)
HEAD_ROWS = 8

# Launches of the CUDA policy kernel in this process (plain integer; the
# wrapper adds one per launch and nowhere else).
policy_kernel_launches = 0


class EvalWeights(NamedTuple):
    """Actor weights in the JAX package's transposed, value-major layout.

    `wt1` is `(H1, V²·20)` bf16 over the value-major feature rows (row
    `off_ch + v·V² + kv` is the one-hot of channel value `v` at packed view
    cell `kv`); `wta` is the 8-row head, rows `0..num_actions-1` the actor
    logits and the rest pinned by a −1e9 bias."""

    wt1: torch.Tensor  # (H1, F_total) bf16
    b1: torch.Tensor  # (H1, 1) bf16
    wt2: torch.Tensor  # (H2, H1) bf16
    b2: torch.Tensor  # (H2, 1) bf16
    wta: torch.Tensor  # (8, H2) f32
    ba: torch.Tensor  # (8, 1) f32


def _feature_permutation(view: int) -> np.ndarray:
    """Map the value-major feature row -> flax feature index.

    flax (`models.policy.encode_obs`): index = k_img·20 + offset + v with
    k_img = x·V + y ([x, y] image order). Kernel: row = off_ch + v·V² + kv
    with kv = y·V + x (packed view order)."""
    v2 = view * view
    perm = np.zeros(v2 * _F, dtype=np.int64)
    off = 0
    ch_off = (0, CHANNEL_WIDTHS[0], CHANNEL_WIDTHS[0] + CHANNEL_WIDTHS[1])
    for ch, width in enumerate(CHANNEL_WIDTHS):
        for val in range(width):
            for kv in range(v2):
                x, y = kv % view, kv // view
                perm[off + val * v2 + kv] = (x * view + y) * _F + ch_off[ch] + val
        off += width * v2
    return perm


def _tree_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def eval_weights_from_params(params, view: int, device=None) -> EvalWeights:
    """An `ActorCritic` module, or a flax params tree of numpy arrays ->
    `EvalWeights` (transpose + permute) on `device` (default: the module's
    device, or the card for a numpy tree)."""
    if isinstance(params, nn.Module):
        if device is None:
            device = next(params.parameters()).device
        params = params.flax_params()
    device = default_device(device)
    p = params["params"]
    f = functools.partial(_tree_tensor, device=device)
    perm = torch.from_numpy(_feature_permutation(view)).to(device)
    w1 = f(p["torso_0"]["kernel"])[perm, :]  # (980, H1)
    wa = f(p["actor"]["kernel"])  # (H2, A)
    a = wa.shape[1]
    wa_pad = torch.zeros((HEAD_ROWS, wa.shape[0]), dtype=torch.float32, device=device)
    wa_pad[:a] = wa.T
    ba_pad = torch.full((HEAD_ROWS, 1), -1e9, dtype=torch.float32, device=device)
    ba_pad[:a, 0] = f(p["actor"]["bias"])
    return EvalWeights(
        wt1=w1.T.to(torch.bfloat16).contiguous(),
        b1=f(p["torso_0"]["bias"]).to(torch.bfloat16)[:, None],
        wt2=f(p["torso_1"]["kernel"]).T.to(torch.bfloat16).contiguous(),
        b2=f(p["torso_1"]["bias"]).to(torch.bfloat16)[:, None],
        wta=wa_pad,
        ba=ba_pad,
    )


def _bf16_bias_relu(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(bf16(acc) + bias) in bf16; the add runs in f32 and rounds once."""
    h = acc.to(torch.bfloat16).float() + bias.float()
    return torch.relu(h.to(torch.bfloat16))


def policy_logits(vw: torch.Tensor, vis: torch.Tensor, w: EvalWeights, view: int) -> torch.Tensor:
    """(V², B) packed view -> (8, B) f32 head rows. Mirrors the flax
    forward (bf16 torso, f32 head) on the transposed layout; the bf16
    products are taken as f32 GEMMs, which is exact for bf16 inputs."""
    rows = []
    for chan, width in zip(((vw & 15) * vis, ((vw >> 4) & 15) * vis, ((vw >> 8) & 15) * vis), CHANNEL_WIDTHS):
        for val in range(width):
            rows.append(chan == val)
    feats = torch.cat(rows, dim=0).to(torch.float32)  # (V²·20, B), exact 0/1
    h1 = _bf16_bias_relu(w.wt1.float() @ feats, w.b1)
    h2 = _bf16_bias_relu(w.wt2.float() @ h1.float(), w.b2)
    return w.wta @ h2.float() + w.ba


def sample_categorical(logits: torch.Tensor, seed_row: torch.Tensor, num_actions: int) -> torch.Tensor:
    """(8, B) head rows + (1, B) int32 seeds -> (1, B) int32 actions."""
    a, _ = sample_categorical_with_logp(logits, seed_row, num_actions)
    return a


def sample_categorical_with_logp(logits: torch.Tensor, seed_row: torch.Tensor, num_actions: int):
    """Inverse-CDF categorical over the first `num_actions` head rows with
    one 31-bit Threefry uniform per lane, op for op as the JAX package
    draws it, and the drawn action's log-probability."""
    u31 = hash_u31(seed_row, _SEED_SALT, 0)
    u01 = u31.to(torch.float32) * (2.0**-31)
    m = logits[0:1]
    for i in range(1, num_actions):
        m = torch.maximum(m, logits[i : i + 1])
    cum = torch.zeros_like(u01)
    cums = []
    for i in range(num_actions):
        cum = cum + torch.exp(logits[i : i + 1] - m)
        cums.append(cum)
    thresh = u01 * cum
    hits = torch.zeros_like(seed_row, dtype=torch.int32)
    for cu in cums:
        hits = hits + (cu > thresh).to(torch.int32)
    action = num_actions - hits
    l_a = torch.zeros_like(u01)
    for i in range(num_actions):
        l_a = torch.where(action == i, logits[i : i + 1], l_a)
    return action, (l_a - m) - torch.log(cum)


def _seeds_for(key: torch.Tensor, num_steps: int, b: int) -> torch.Tensor:
    """The `(T, B)` int32 sampling seeds: `jax.random.bits(key, (T, B))`
    as int32 bit patterns."""
    return random_bits(key, (num_steps, b), dtype=torch.int32)


def plain_policy_rollout(words, regs, tmpl_words, tmpl_regs, seeds, weights: EvalWeights, config: EnvConfig):
    """`T = seeds.shape[0]` policy-driven packed steps as a loop of torch
    ops, on any device. Returns `(words', regs', rsum, episodes, checksum)`
    with `(1, B)` per-lane accumulators (f32, int32, int32)."""
    v = config.agent_view_size
    b = words.shape[1]
    dev = words.device
    step = functools.partial(
        step_core,
        width=config.width,
        height=config.height,
        view=v,
        max_steps=config.max_steps,
        see_through_walls=config.see_through_walls,
        with_obs=True,
    )
    vw, vis = obs_core(
        words, regs, width=config.width, height=config.height, view=v,
        see_through_walls=config.see_through_walls,
    )
    rsum = torch.zeros((1, b), dtype=torch.float32, device=dev)
    epi = torch.zeros((1, b), dtype=torch.int32, device=dev)
    csum = torch.zeros((1, b), dtype=torch.int32, device=dev)
    for t in range(seeds.shape[0]):
        a = sample_categorical(policy_logits(vw, vis, weights, v), seeds[t : t + 1], config.num_actions)
        words, regs, reward, done, obs_sum, vw, vis = step(words, regs, a, tmpl_words, tmpl_regs)
        rsum = rsum + reward
        epi = epi + done.to(torch.int32)
        csum = csum + obs_sum
    return words, regs, rsum, epi, csum


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------


def padded_features(view: int) -> int:
    """V²·20 features rounded up to whole 16-wide k tiles of `mma.sync`."""
    return -(-view * view * _F // 16) * 16


def policy_smem_bytes(config: EnvConfig, bt: int) -> int:
    """Shared memory of one block of `bt` lanes, as `csrc/policy_kernel.cu`
    lays it out: h1 `[bt][256 + 8]`, the features `[bt][K + 8]` and h2
    `[256][bt + 8]` in bf16, the head weights and biases in f32, the grids
    `[HW][bt]` and the offset tables in int32. The launch takes this count."""
    v = config.agent_view_size
    hw = config.width * config.height
    return (
        bt * (HIDDEN + 8) * 2 + bt * (padded_features(v) + 8) * 2 + HIDDEN * (bt + 8) * 2
        + (HEAD_ROWS * HIDDEN + 2 * HIDDEN + HEAD_ROWS) * 4
        + hw * bt * 4 + (4 + 4 * v * v) * 4
    )


def policy_lane_block(config: EnvConfig) -> int:
    """Lanes per CUDA block: 64, or 32 where 64 lanes' grids do not fit one
    block's shared memory. Raises on a configuration the kernel does not
    take."""
    v = config.agent_view_size
    if v < 3 or v % 2 == 0 or v > _MAX_VIEW:
        raise ValueError(f"policy kernel: view size {v} must be odd and in [3, {_MAX_VIEW}]")
    if not 1 <= config.num_actions <= HEAD_ROWS:
        raise ValueError(f"policy kernel: {config.num_actions} actions; the head has {HEAD_ROWS} rows")
    for bt in (64, 32):
        if policy_smem_bytes(config, bt) <= _SMEM_LIMIT:
            return bt
    raise ValueError(
        f"policy kernel: a {config.width}x{config.height} grid needs "
        f"{policy_smem_bytes(config, 32)} B of shared memory for 32 lanes; the limit is {_SMEM_LIMIT}"
    )


def policy_rollout_supported(env: Env, mode: str = "cached") -> bool:
    """True iff `build_policy_eval_rollout` runs `env` under `mode`: the base
    transition, cached mode or regen on a static layout, and a grid and
    view the kernel's shared-memory budget takes."""
    if env.transition != BASE_STEP or mode not in ("cached", "regen"):
        return False
    if mode == "regen" and not _regen_is_static(env):
        return False
    try:
        policy_lane_block(env.config)
    except ValueError:
        return False
    return True


def _a_fragments(w: torch.Tensor) -> torch.Tensor:
    """A `(256, K)` bf16 matrix, its columns zero-padded to whole 16-wide
    tiles, in mma.sync m16n8k16 A-fragment order: `(16, K/16, 32, 8)` over
    (row tile, k tile, thread, element). Thread `l` (group `g = l // 4`,
    `t = l % 4`) holds rows g, g+8, g, g+8 at columns 2t, 2t, 2t+8, 2t+8
    (each two consecutive columns) of the 16x16 tile."""
    m, k = w.shape
    kp = -(-k // 16) * 16
    if kp != k:
        w = torch.cat([w, w.new_zeros((m, kp - k))], dim=1)
    w = w.reshape(m // 16, 16, kp // 16, 16).permute(0, 2, 1, 3)  # (mt, kt, r, c)
    lanes = torch.arange(32, device=w.device)
    g, t = lanes // 4, lanes % 4
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], dim=1)  # (32, 8)
    cols = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9, 2 * t + 8, 2 * t + 9], dim=1)
    return w[:, :, rows, cols].contiguous()


def _check_operands(operands, device) -> None:
    """Every operand's dtype, shape and layout first, then its device, so
    that a wrong operand is named whatever device it lies on."""
    for name, t, shape, dtype in operands:
        if t.dtype != dtype:
            raise TypeError(f"policy kernel: {name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"policy kernel: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"policy kernel: {name} is not contiguous")
    for name, t, _, _ in operands:
        if t.device.type != "cuda":
            raise ValueError(f"policy kernel: {name} is on {t.device}, expected a CUDA device")
        if t.device != device:
            raise ValueError(f"policy kernel: {name} is on {t.device}, words on {device}")


def run_policy_kernel(words, regs, tmpl_words, tmpl_regs, seeds, weights: EvalWeights, config: EnvConfig):
    """The policy kernel's wrapper: same arguments and results as
    `plain_policy_rollout`.

    CPU tensors run `plain_policy_rollout`; CUDA tensors launch the kernel
    on the current stream, and any other device, operand the kernel does
    not take, failed build or failed launch raises."""
    if words.device.type == "cpu":
        return plain_policy_rollout(words, regs, tmpl_words, tmpl_regs, seeds, weights, config)
    hw = config.width * config.height
    b = words.shape[1]
    t = seeds.shape[0]
    dev = words.device
    f_total = config.agent_view_size**2 * _F
    _check_operands((
        ("words", words, (hw, b), torch.int32),
        ("regs", regs, (NUM_REGS, b), torch.int32),
        ("tmpl_words", tmpl_words, (hw, b), torch.int32),
        ("tmpl_regs", tmpl_regs, (NUM_REGS, b), torch.int32),
        ("seeds", seeds, (t, b), torch.int32),
        ("wt1", weights.wt1, (HIDDEN, f_total), torch.bfloat16),
        ("b1", weights.b1, (HIDDEN, 1), torch.bfloat16),
        ("wt2", weights.wt2, (HIDDEN, HIDDEN), torch.bfloat16),
        ("b2", weights.b2, (HIDDEN, 1), torch.bfloat16),
        ("wta", weights.wta, (HEAD_ROWS, HIDDEN), torch.float32),
        ("ba", weights.ba, (HEAD_ROWS, 1), torch.float32),
    ), dev)
    if b == 0 or t == 0:
        raise ValueError(f"policy kernel: empty batch or step count ({b}, {t})")
    bt = policy_lane_block(config)
    from minigrid_tpu_torch.ops import _build

    lib = _build.load_library(dev)
    # W1 and W2 in fragment order: one gather each, made on every call so
    # that the kernel always reads the weights it was given.
    w1frag, w2frag = _a_fragments(weights.wt1), _a_fragments(weights.wt2)
    words_out = torch.empty_like(words)
    regs_out = torch.empty_like(regs)
    rsum = torch.empty((1, b), dtype=torch.float32, device=dev)
    counts = torch.empty((2, b), dtype=torch.int32, device=dev)
    tables = _kernel_tables(config.width, config.height, config.agent_view_size, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_policy_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                words, regs, tmpl_words, tmpl_regs, seeds, tables,
                w1frag, weights.b1, w2frag, weights.b2, weights.wta, weights.ba,
                words_out, regs_out, rsum, counts,
            )),
            b, t, config.width, config.height, config.agent_view_size, config.max_steps,
            int(config.see_through_walls), NUM_REGS, config.num_actions, bt, policy_smem_bytes(config, bt),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"policy kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})"
        )
    global policy_kernel_launches
    policy_kernel_launches += 1
    return words_out, regs_out, rsum, counts[0:1], counts[1:2]


# --------------------------------------------------------------------------
# The evaluation surface
# --------------------------------------------------------------------------


def build_policy_eval_rollout(env: Env, params, num_steps: int, mode: str = "cached", as_carry: bool = False):
    """`rollout(key, states) -> (states, RolloutMetrics)` with the actor in
    the loop, or with `as_carry=True` the steady surface `step(key, carry)
    -> (carry, RolloutMetrics)` over a `PackedCarry` from `packed_init`.

    `params` is an `ActorCritic` or a flax params tree of numpy arrays,
    converted on every call (`eval_weights_from_params`, far cheaper than
    the rollout), so a module updated in place between calls is evaluated
    with its new weights. The `(2,)` key
    only seeds the per-(step, lane) sampling stream, as in the JAX package.
    The loop runs in the CUDA kernel for CUDA tensors and in the plain twin
    for CPU tensors."""
    _check_supported(env, mode)
    if not policy_rollout_supported(env, mode):
        raise ValueError(f"policy rollout (mode={mode!r}) does not support {env.env_id!r}")
    view = env.config.agent_view_size

    def run_core(words, regs, tmpl_words, tmpl_regs, seeds, config):
        weights = eval_weights_from_params(params, view, device=words.device)
        return run_policy_kernel(words, regs, tmpl_words, tmpl_regs, seeds, weights, config)

    def seeds_for(key, b, dev):
        return _seeds_for(key.to(dev), num_steps, b)

    return build_carry_surface(env, num_steps, mode, as_carry, run_core, seeds_for)
