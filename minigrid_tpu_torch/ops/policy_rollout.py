"""The actor inside the packed rollout, in one hand-written CUDA kernel,
plus its plain twin (counterpart of `minigrid_tpu/ops/policy_rollout.py`):
policy-in-the-loop evaluation, and the trajectory-collecting rollout of
the fused train step.

Each step, every lane runs the `ActorCritic` actor on its pre-step view,
draws an action by inverse CDF from one Threefry uniform of a precomputed
`(T, B)` int32 seed (the key of `step(key, carry)` makes the seeds, as
`jax.random.bits` does), and takes the packed step of
`ops/fused_rollout.py`. In eval mode nothing but the carry and the
metrics leaves the call; in collect mode each step also spills one slab
of the trajectory (the pre-step obs words, the action, its
log-probability, the critic's value, the reward and done). Which code
runs is decided by where the tensors lie: on a CUDA device
`run_policy_kernel` launches `csrc/policy_kernel.cu` (or raises); on the
CPU it runs the plain twin `plain_policy_rollout`.

`policy_logits` mirrors the flax forward on the JAX package's transposed,
value-major weight layout (`EvalWeights`, kept at the public surface so
that tests compare like with like): bf16 operands, f32 sums rounded to
bf16, bf16 bias adds, f32 head. Its f32 GEMMs run in full f32; keep
`torch.backends.cuda.matmul.allow_tf32` off when the twin runs on a card.
Under weights whose f32 sums are exact in any order (a sparse dyadic
grid, `testing.dyadic_flax_params`) the port, the kernel and the JAX
package agree byte for byte; under other weights the summation order can
flip a bf16 rounding, and with it, rarely, a sampled action.

Scope: the base transition and every family's hooks
(`ops/packed_hooks.py`: the nine post-hooks, the DynamicObstacles
pre-hook and the two action remaps), in cached mode and in regen mode. Regen on a
static-layout family (fixed-start Empty, DistShift) keeps the template;
on a random-layout family both evaluation and the collecting rollout run
exact chunked regen (`ops/chunked_regen.py`), the kernel and its twin
under the commit rows `ctl`, the collected trajectory placed by the spill
merge (I6 there).
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
from minigrid_tpu_torch.ops.chunked_regen import build_chunked_regen
from minigrid_tpu_torch.ops.fused_rollout import (
    _MAX_VIEW,
    _SMEM_LIMIT,
    PackedCarry,
    _check_supported,
    _fit_chunk,
    _kernel_tables,
    _regen_is_static,
    _replay_rng_chain,
    _surface,
    build_carry_surface,
    hook_kwargs,
    obs_core,
    obstacle_rows,
    packed_step_supported,
    rollout_metrics,
    step_core,
)
from minigrid_tpu_torch.ops.packed_gen import packed_generator
from minigrid_tpu_torch.ops.packed_hooks import KERNEL_HOOK_IDS, packed_hook
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
    """A params leaf as f32 on `device`. A tensor stays in its autograd
    graph, so weights built from leaves that require grad are
    differentiable (`parallel/train.py` pulls cotangents back through
    them)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _params_tree(params, device):
    """(the `params` dict of a flax params tree, device). `params` is an
    `ActorCritic` (detached weights, on its device unless `device` says
    otherwise) or a flax tree of numpy arrays (on the card by default) or
    of tensors (on their device by default)."""
    if isinstance(params, nn.Module):
        if device is None:
            device = next(params.parameters()).device
        params = params.flax_params()
    elif device is None and isinstance(params["params"]["torso_0"]["kernel"], torch.Tensor):
        device = params["params"]["torso_0"]["kernel"].device
    return params["params"], default_device(device)


def _weights(params, view: int, device, critic: bool) -> EvalWeights:
    p, device = _params_tree(params, device)
    f = functools.partial(_tree_tensor, device=device)
    perm = torch.from_numpy(_feature_permutation(view)).to(device)
    w1 = f(p["torso_0"]["kernel"])[perm, :]  # (980, H1)
    wa = f(p["actor"]["kernel"])  # (H2, A)
    h2, a = wa.shape
    if a > HEAD_ROWS - critic:
        raise ValueError(f"{a} actions{' and the critic' if critic else ''} do not fit the {HEAD_ROWS}-row head")
    pad = HEAD_ROWS - a - critic
    wta = [wa.T, wa.new_zeros((pad, h2))]
    ba = [f(p["actor"]["bias"])[:, None], wa.new_full((pad, 1), -1e9)]
    if critic:  # head row 7
        wta.append(f(p["critic"]["kernel"]).T)
        ba.append(f(p["critic"]["bias"])[:, None])
    return EvalWeights(
        wt1=w1.T.to(torch.bfloat16).contiguous(),
        b1=f(p["torso_0"]["bias"]).to(torch.bfloat16)[:, None],
        wt2=f(p["torso_1"]["kernel"]).T.to(torch.bfloat16).contiguous(),
        b2=f(p["torso_1"]["bias"]).to(torch.bfloat16)[:, None],
        wta=torch.cat(wta).contiguous(),
        ba=torch.cat(ba),
    )


def eval_weights_from_params(params, view: int, device=None) -> EvalWeights:
    """An `ActorCritic` module, or a flax params tree of numpy arrays or
    tensors -> `EvalWeights` (transpose + permute) on `device` (default:
    the module's or the tensors' device, or the card for a numpy tree)."""
    return _weights(params, view, device, critic=False)


def train_weights_from_params(params, view: int, device=None) -> EvalWeights:
    """Like `eval_weights_from_params`, with the critic head in row 7.

    From a tree of tensors that require grad the result is differentiable:
    the permutation, transposes, bf16 casts and padding are linear, and the
    adjoint of each bf16 cast is the cast back to f32, as in JAX."""
    return _weights(params, view, device, critic=True)


def _bf16_bias(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(acc) + bias): the pre-activation; the add runs in f32 and
    rounds once, as torch and XLA:CPU add two bf16."""
    return (acc.to(torch.bfloat16).float() + bias.float()).to(torch.bfloat16)


def features(vw: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(V², B) packed view + visibility -> (V²·20, B) f32 value-major
    one-hot rows (exact 0/1); a value at or above its channel's width
    matches no row."""
    rows = []
    for chan, width in zip((vw & 15, (vw >> 4) & 15, (vw >> 8) & 15), CHANNEL_WIDTHS):
        chan = chan * vis
        for val in range(width):
            rows.append(chan == val)
    return torch.cat(rows, dim=0).to(torch.float32)


def torso(feats: torch.Tensor, w: EvalWeights):
    """(V²·20, B) features -> the bf16 pre-activations `(h1_pre, h2_pre)`
    of the two torso layers; each layer's input is the relu of the one
    before. The bf16 products are taken as f32 GEMMs, which is exact for
    bf16 inputs."""
    h1p = _bf16_bias(w.wt1.float() @ feats, w.b1)
    h2p = _bf16_bias(w.wt2.float() @ torch.relu(h1p).float(), w.b2)
    return h1p, h2p


def policy_logits(vw: torch.Tensor, vis: torch.Tensor, w: EvalWeights, view: int) -> torch.Tensor:
    """(V², B) packed view -> (8, B) f32 head rows. Mirrors the flax
    forward (bf16 torso, f32 head) on the transposed layout."""
    _, h2p = torso(features(vw, vis), w)
    return w.wta @ torch.relu(h2p).float() + w.ba


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


def _seeds_for(key: torch.Tensor, num_steps: int, b: int, lane0: int = 0, total=None) -> torch.Tensor:
    """The `(T, B)` int32 sampling seeds: `jax.random.bits(key, (T, B))`
    as int32 bit patterns. With `lane0` and `total`, the `b` columns from
    `lane0` of the `(T, total)` draw of a whole batch (a shard's lanes)."""
    return random_bits(key, (num_steps, b), dtype=torch.int32, lane0=lane0, total=total)


def pack_obs_words(vw: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(V², B) view + visibility -> one int32 obs word per cell: the
    `(type, color, state)` triple of the encoded observation, zero where
    occluded (the compact form the collect mode spills)."""
    return (vw & 0xFFF) * vis


def obs_words_to_images(words: torch.Tensor, view: int) -> torch.Tensor:
    """(..., V², B) packed obs words -> (..., B, V, V, 3) uint8 images in
    the JAX package's `[x, y]` order."""
    img = torch.stack([words & 15, (words >> 4) & 15, (words >> 8) & 15], dim=-1)  # (..., V², B, 3)
    img = img.reshape(img.shape[:-3] + (view, view) + img.shape[-2:])  # (..., y, x, B, 3)
    n = img.ndim
    return img.permute(*range(n - 4), n - 2, n - 3, n - 4, n - 1).to(torch.uint8)


def _spill_rows(v2: int) -> int:
    """Rows of the per-step trajectory slab: the V² obs words and 5 scalar
    rows (action, logp, value, reward, done), rounded up to a multiple of
    8 as in the JAX package (56 at V = 7)."""
    return ((v2 + 5 + 7) // 8) * 8


def _traj_views(spill: torch.Tensor, v2: int):
    """`(obs_words (T, V², B) i32, actions (T, B) i32, logp, value, reward
    (T, B) f32, done (T, B) i32)`: views of the `(T, rows, B)` spill, the
    float rows reinterpreted from their bits."""
    return (
        spill[:, :v2],
        spill[:, v2],
        spill[:, v2 + 1].view(torch.float32),
        spill[:, v2 + 2].view(torch.float32),
        spill[:, v2 + 3].view(torch.float32),
        spill[:, v2 + 4],
    )


def plain_policy_rollout(
    words, regs, tmpl_words, tmpl_regs, seeds, weights: EvalWeights, config: EnvConfig, collect: bool = False,
    ctl=None, transition=BASE_STEP,
):
    """`T = seeds.shape[0]` policy-driven packed steps as a loop of torch
    ops, on any device, under `transition`'s hook. Returns `(words', regs',
    rsum, episodes, checksum)` with `(1, B)` per-lane accumulators (f32,
    int32, int32); with `collect=True` also the trajectory (`_traj_views`
    of a `(T, rows, B)` int32 spill, rows as the kernel writes them,
    padding rows zero). With `ctl`, the `(3, B)` int32 commit rows of
    exact chunked regen, the T steps are one chunk under the commit
    protocol, and the updated rows come last; the spill then holds each
    step at its pass-local row, and only a lane's committed rows are
    defined (`chunked_regen._merge_spill` places them)."""
    v = config.agent_view_size
    v2 = v * v
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
        **hook_kwargs(transition, config),
    )
    if ctl is not None:
        step = functools.partial(step, chunk_len=seeds.shape[0])
    vw, vis = obs_core(
        words, regs, width=config.width, height=config.height, view=v,
        see_through_walls=config.see_through_walls,
    )
    rsum = torch.zeros((1, b), dtype=torch.float32, device=dev)
    epi = torch.zeros((1, b), dtype=torch.int32, device=dev)
    csum = torch.zeros((1, b), dtype=torch.int32, device=dev)
    if collect:
        spill = torch.zeros((seeds.shape[0], _spill_rows(v2), b), dtype=torch.int32, device=dev)
    for t in range(seeds.shape[0]):
        logits = policy_logits(vw, vis, weights, v)
        a, logp = sample_categorical_with_logp(logits, seeds[t : t + 1], config.num_actions)
        if collect:
            spill[t, :v2] = pack_obs_words(vw, vis)
            spill[t, v2] = a[0]
            spill[t, v2 + 1] = logp[0].view(torch.int32)
            spill[t, v2 + 2] = logits[7].view(torch.int32)
        if ctl is None:
            words, regs, reward, done, obs_sum, vw, vis = step(words, regs, a, tmpl_words, tmpl_regs)
        else:
            words, regs, reward, done, obs_sum, ctl, vw, vis = step(
                words, regs, a, tmpl_words, tmpl_regs, chunk_ctl=ctl
            )
        if collect:
            spill[t, v2 + 3] = reward[0].view(torch.int32)
            spill[t, v2 + 4] = done[0].to(torch.int32)
        rsum = rsum + reward
        epi = epi + done.to(torch.int32)
        csum = csum + obs_sum
    out = (words, regs, rsum, epi, csum)
    if collect:
        out += (_traj_views(spill, v2),)
    return out + (ctl,) if ctl is not None else out


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------


def padded_features(view: int) -> int:
    """V²·20 features rounded up to whole 16-deep k slabs of `wgmma` (a
    multiple of 32 for an odd view)."""
    return -(-view * view * _F // 16) * 16


CHUNK_BYTES = 16384  # one slot of the kernels' weight ring: a 64 (K) x 128 (N) bf16 chunk
MAX_STAGES = 16  # ring slots the kernels' bookkeeping provides for
MIN_STAGES = 3
_BAR_BYTES = 1024  # the ring's bookkeeping; keeps the slots 1024-aligned for the swizzle


def _smem_without_ring(config: EnvConfig, bt: int) -> int:
    """Shared memory of one block of `bt` lanes besides the weights, as
    `csrc/policy_kernel.cuh::PolicySmem` carves it: the ring's bookkeeping,
    the head weights and biases in f32, the offset tables in int32 (padded
    to 16 bytes), the grids `[HW][bt]` and the obstacle rows `[4n][bt]`
    (`obstacle_rows`) in int32, and the lanes' feature bits `[K/32][bt]`
    in uint32."""
    v = config.agent_view_size
    v2 = v * v
    hw = config.width * config.height
    return (
        _BAR_BYTES + (HEAD_ROWS * HIDDEN + 2 * HIDDEN + HEAD_ROWS) * 4 + -(-(4 + 4 * v2) // 4) * 16
        + hw * bt * 4 + obstacle_rows(config) * bt * 4 + padded_features(v) // 32 * bt * 4
    )


def ring_stages(free_bytes: int):
    """Slots of a weight ring in `free_bytes` of shared memory, up to
    MAX_STAGES; None below MIN_STAGES."""
    stages = min(MAX_STAGES, free_bytes // CHUNK_BYTES)
    return stages if stages >= MIN_STAGES else None


def policy_plan(config: EnvConfig, bt: int):
    """`(stages, smem_bytes)` of a block of `bt` lanes: the weight ring
    takes the shared memory the block's other buffers leave; None where
    not even MIN_STAGES slots fit."""
    base = _smem_without_ring(config, bt)
    stages = ring_stages(_SMEM_LIMIT - base)
    return None if stages is None else (stages, base + stages * CHUNK_BYTES)


def policy_smem_bytes(config: EnvConfig, bt: int) -> int:
    """Shared memory of one block of `bt` lanes as `policy_plan` lays it
    out (the launch takes this count), or, where that plan does not fit,
    what its smallest ring would need."""
    plan = policy_plan(config, bt)
    return plan[1] if plan is not None else _smem_without_ring(config, bt) + MIN_STAGES * CHUNK_BYTES


def policy_lane_block(config: EnvConfig) -> int:
    """Lanes per CUDA block: 128 (two warpgroups of 64), or 64 where 128
    lanes' grids do not fit one block's shared memory. Raises on a
    configuration the kernel does not take."""
    v = config.agent_view_size
    if v < 3 or v % 2 == 0 or v > _MAX_VIEW:
        raise ValueError(f"policy kernel: view size {v} must be odd and in [3, {_MAX_VIEW}]")
    if not 1 <= config.num_actions <= HEAD_ROWS:
        raise ValueError(f"policy kernel: {config.num_actions} actions; the head has {HEAD_ROWS} rows")
    for bt in (128, 64):
        if policy_plan(config, bt) is not None:
            return bt
    raise ValueError(
        f"policy kernel: a {config.width}x{config.height} grid needs "
        f"{policy_smem_bytes(config, 64)} B of shared memory for 64 lanes; the limit is {_SMEM_LIMIT}"
    )


def policy_rollout_supported(env: Env, mode: str = "cached", collect: bool = False) -> bool:
    """True iff the policy rollouts run `env` under `mode`: the base
    transition or a ported hook; cached mode, regen on a static layout, or
    chunked regen on a family with a packed generator; and a grid and view
    the kernel's shared-memory budget takes. The collecting rollout
    (`collect=True`) also needs head row 7 free for the critic."""
    if not packed_step_supported(env, mode):
        return False
    if collect and env.config.num_actions >= HEAD_ROWS:
        return False
    try:
        policy_lane_block(env.config)
    except ValueError:
        return False
    return True


def _b_chunks(w: torch.Tensor, k_outer: bool) -> torch.Tensor:
    """A `(256, K)` matrix as the B operand `wᵀ` of `wgmma`, flat, in the
    16 KB chunks the kernels' weight ring streams: K zero-padded to whole
    16-deep k slabs; each 64-deep K chunk `kc` of each N half `h` (rows
    128·h ..) as 128 rows of 64 bf16 in the 128-byte swizzle (element
    `(n, k)` at byte `sw128_offset(n % 128, k % 64)` of its chunk: row·128
    + 16·((k/8 % 8) ^ (row % 8)) + 2·(k % 8)), chunks in (kc, h) order if
    `k_outer` (W1ᵀ, both halves of a K chunk together) else (h, kc) (W2ᵀ,
    one half at a time); then, where 32 of K are left, a tail chunk of two
    16 x 256 k slabs in 8 x 8 core matrices without swizzle (slab `s` at
    8192·s, element `(n, k)` at 256·(n/8) + 128·(k/8 % 2) + 16·(n % 8) +
    2·(k % 8))."""
    n, k = w.shape
    kp = -(-k // 16) * 16
    if kp != k:
        w = torch.cat([w, w.new_zeros((n, kp - k))], dim=1)
    full = kp // 64 * 64
    x = w[:, :full].reshape(2, n // 2, full // 64, 8, 8).permute(0, 2, 1, 3, 4)  # (h, kc, row, group, e)
    rows = torch.arange(n // 2, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)[:, None]  # group at each swizzled position
    x = torch.gather(x, 3, src[None, None, :, :, None].expand(x.shape))
    parts = [(x.transpose(0, 1) if k_outer else x).reshape(-1)]
    if full < kp:
        parts.append(w[:, full:].reshape(n // 8, 8, (kp - full) // 16, 2, 8).permute(2, 0, 3, 1, 4).reshape(-1))
    return torch.cat(parts)


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


def run_policy_kernel(
    words, regs, tmpl_words, tmpl_regs, seeds, weights: EvalWeights, config: EnvConfig, collect: bool = False,
    ctl=None, transition=BASE_STEP,
):
    """The policy kernel's wrapper: same arguments and results as
    `plain_policy_rollout`, the trajectory with `collect=True` as views of
    one `(T, rows, B)` int32 spill that the kernel writes (under `ctl`,
    only the rows each lane committed).

    CPU tensors run `plain_policy_rollout`; CUDA tensors launch the kernel
    on the current stream, and any other device, operand the kernel does
    not take, hook that is not ported, failed build or failed launch
    raises."""
    if words.device.type == "cpu":
        return plain_policy_rollout(
            words, regs, tmpl_words, tmpl_regs, seeds, weights, config, collect, ctl, transition
        )
    packed_hook(transition, config)  # raises for a transition without hooks
    hook_id = KERNEL_HOOK_IDS[transition]
    hw = config.width * config.height
    b = words.shape[1]
    t = seeds.shape[0]
    dev = words.device
    v2 = config.agent_view_size**2
    if collect and config.num_actions >= HEAD_ROWS:
        raise ValueError(f"policy kernel: collect mode reads the critic from head row {HEAD_ROWS - 1}, "
                         f"which {config.num_actions} actions occupy")
    _check_operands((
        ("words", words, (hw, b), torch.int32),
        ("regs", regs, (NUM_REGS, b), torch.int32),
        ("tmpl_words", tmpl_words, (hw, b), torch.int32),
        ("tmpl_regs", tmpl_regs, (NUM_REGS, b), torch.int32),
        ("seeds", seeds, (t, b), torch.int32),
        ("wt1", weights.wt1, (HIDDEN, v2 * _F), torch.bfloat16),
        ("b1", weights.b1, (HIDDEN, 1), torch.bfloat16),
        ("wt2", weights.wt2, (HIDDEN, HIDDEN), torch.bfloat16),
        ("b2", weights.b2, (HIDDEN, 1), torch.bfloat16),
        ("wta", weights.wta, (HEAD_ROWS, HIDDEN), torch.float32),
        ("ba", weights.ba, (HEAD_ROWS, 1), torch.float32),
        *((("ctl", ctl, (3, b), torch.int32),) if ctl is not None else ()),
    ), dev)
    if b == 0 or t == 0:
        raise ValueError(f"policy kernel: empty batch or step count ({b}, {t})")
    bt = policy_lane_block(config)
    stages, smem = policy_plan(config, bt)
    from minigrid_tpu_torch.ops import _build

    lib = _build.load_library(dev)
    # W1ᵀ and W2ᵀ in the ring's chunks: one gather each, made on every call
    # so that the kernel always reads the weights it was given.
    w1s, w2s = _b_chunks(weights.wt1, True), _b_chunks(weights.wt2, False)
    words_out = torch.empty_like(words)
    regs_out = torch.empty_like(regs)
    rsum = torch.empty((1, b), dtype=torch.float32, device=dev)
    counts = torch.empty((2, b), dtype=torch.int32, device=dev)
    rows = _spill_rows(v2)
    spill = torch.empty((t, rows, b), dtype=torch.int32, device=dev) if collect else None
    ctl_out = torch.empty((3, b), dtype=torch.int32, device=dev) if ctl is not None else None
    tables = _kernel_tables(config.width, config.height, config.agent_view_size, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_policy_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                words, regs, tmpl_words, tmpl_regs, seeds, tables,
                w1s, weights.b1, w2s, weights.b2, weights.wta, weights.ba,
                words_out, regs_out, rsum, counts,
            )),
            *(ctypes.c_void_p(x.data_ptr() if x is not None else None) for x in (spill, ctl, ctl_out)),
            b, t, config.width, config.height, config.agent_view_size, config.max_steps,
            int(config.see_through_walls), NUM_REGS, config.num_actions, rows, hook_id,
            config.n_obstacles or 0, bt, stages, smem, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"policy kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})"
        )
    global policy_kernel_launches
    policy_kernel_launches += 1
    out = (words_out, regs_out, rsum, counts[0:1], counts[1:2])
    if collect:
        out += (_traj_views(spill, v2),)
    return out + (ctl_out,) if ctl is not None else out


# --------------------------------------------------------------------------
# The evaluation surface
# --------------------------------------------------------------------------


def build_policy_eval_rollout(
    env: Env, params, num_steps: int, mode: str = "cached", as_carry: bool = False, regen_chunk: int = 32
):
    """`rollout(key, states) -> (states, RolloutMetrics)` with the actor in
    the loop, or with `as_carry=True` the steady surface `step(key, carry)
    -> (carry, RolloutMetrics)` over a `PackedCarry` from `packed_init`.

    `params` is an `ActorCritic` or a flax params tree of numpy arrays,
    converted on every kernel pass (`eval_weights_from_params`, far
    cheaper than the pass), so a module updated in place between calls is
    evaluated with its new weights. The `(2,)` key
    only seeds the per-(step, lane) sampling stream, as in the JAX package.
    The loop runs in the CUDA kernel for CUDA tensors and in the plain twin
    for CPU tensors. In regen mode a random-layout family runs exact
    chunked regen as `build_fused_rollout` does: kernel passes of
    `regen_chunk` steps (the largest divisor of `num_steps` up to it), the
    seed stream pre-shifted per lane as the actions are there."""
    return _build_policy_eval(env, params, num_steps, mode, as_carry, regen_chunk, run_policy_kernel)


def build_policy_eval_plain_rollout(
    env: Env, params, num_steps: int, mode: str = "cached", as_carry: bool = False, regen_chunk: int = 32
):
    """The plain twin of `build_policy_eval_rollout` (same surfaces and
    results) on any device: `plain_policy_rollout`, and a template refresh
    that generates with the plain versions of the generation kernels."""
    return _build_policy_eval(env, params, num_steps, mode, as_carry, regen_chunk, plain_policy_rollout)


def _check_policy_path(env: Env, mode: str, collect: bool = False) -> None:
    """Raise unless the policy rollouts run `env` under `mode`: the packed
    rollout's checks (`NotImplementedError` for a hook or a generator the
    port lacks), then `policy_rollout_supported` (`ValueError`)."""
    _check_supported(env, mode)
    if not policy_rollout_supported(env, mode, collect):
        raise ValueError(f"policy rollout (mode={mode!r}, collect={collect}) does not support {env.env_id!r}")


def _chunked(env: Env, num_steps: int, regen_chunk: int, run, chunk_fn, seeds_for, collect: bool = False):
    """Chunked regen over `chunk_fn` for a random-layout family; the
    template refresh generates with the plain versions of the generation
    kernels when `run` is the plain twin."""
    generate = functools.partial(packed_generator(env), plain=run is plain_policy_rollout)
    tc = _fit_chunk(num_steps, regen_chunk)
    return build_chunked_regen(env, num_steps, tc, chunk_fn, seeds_for, generate, collect=collect)


def _build_policy_eval(env: Env, params, num_steps: int, mode: str, as_carry: bool, regen_chunk: int, run):
    _check_policy_path(env, mode)
    view = env.config.agent_view_size

    def run_core(words, regs, tmpl_words, tmpl_regs, seeds, config, ctl=None):
        weights = eval_weights_from_params(params, view, device=words.device)
        return run(words, regs, tmpl_words, tmpl_regs, seeds, weights, config, ctl=ctl, transition=env.transition)

    def seeds_for(key, b, dev):
        return _seeds_for(key.to(dev), num_steps, b)

    if mode == "regen" and not _regen_is_static(env):

        def chunk_fn(words, regs, tmpl_words, tmpl_regs, seeds, ctl):
            return run_core(words, regs, tmpl_words, tmpl_regs, seeds, env.config, ctl=ctl)

        return _surface(env, mode, as_carry, _chunked(env, num_steps, regen_chunk, run, chunk_fn, seeds_for))
    return build_carry_surface(env, num_steps, mode, as_carry, run_core, seeds_for)


def _no_mark(_piece: str) -> None:
    pass


def build_fused_train_rollout(env: Env, num_steps: int, mode: str = "cached", regen_chunk: int = 32):
    """`rollout(weights, key, carry) -> (carry, traj, RolloutMetrics)`: the
    trajectory-collecting policy rollout that feeds
    `parallel.train.build_fused_train_step`.

    `traj` is `(obs_w (T, V², B) i32, actions (T, B) i32, logp (T, B) f32,
    value (T, B) f32, reward (T, B) f32, done (T, B) i32)`: the raw obs
    words, as the JAX package's `raw_obs=True` gives them
    (`obs_words_to_images` turns them into images). `value` is head row 7
    of the forward that drew the action. `weights` are `EvalWeights` in the
    train layout (`train_weights_from_params`, the critic in head row 7),
    passed on every call, so one built rollout serves every optimizer
    step. The loop runs in the CUDA kernel for CUDA tensors and in the
    plain twin for CPU tensors.

    Cached mode and regen on a static layout take one pass, the
    trajectory as views of its spill. With `lane0` and `total` the carry
    holds lanes `lane0` to `lane0 + B` of a `total`-lane batch, and lane
    `b` draws the seeds lane `lane0 + b` of the whole batch would draw
    (`_seeds_for`): the shard of a train step over a mesh. `mark` is
    called after the seeds ("seeds"), the pass ("collect") and the rng
    replay ("replay"). Regen on a random layout (KeyCorridor, MultiRoom)
    installs a fresh layout at every reset, as the reference does: exact chunked regen with passes of
    `regen_chunk` steps (the largest divisor of `num_steps` up to it), the
    seeds pre-shifted per lane, each pass's spill merged to the lanes'
    commit cursors (`chunked_regen._merge_spill`); `mark` is called at
    chunked regen's pieces ("actions" for the seeds, "kernel", "refresh",
    "reentry", "sums")."""
    return _build_train_rollout(env, num_steps, mode, regen_chunk, run_policy_kernel)


def build_fused_train_plain_rollout(env: Env, num_steps: int, mode: str = "cached", regen_chunk: int = 32):
    """The plain twin of `build_fused_train_rollout` (same surface and
    results) on any device: `plain_policy_rollout`, and a template refresh
    that generates with the plain versions of the generation kernels."""
    return _build_train_rollout(env, num_steps, mode, regen_chunk, plain_policy_rollout)


def _build_train_rollout(env: Env, num_steps: int, mode: str, regen_chunk: int, run):
    _check_policy_path(env, mode, collect=True)

    def seeds_for(source, b, dev):
        key, lane0, total = source
        return _seeds_for(key.to(dev), num_steps, b, lane0, total)

    if mode == "regen" and not _regen_is_static(env):

        def chunk_fn(words, regs, tmpl_words, tmpl_regs, seeds, ctl, weights):
            return run(words, regs, tmpl_words, tmpl_regs, seeds, weights, env.config, collect=True, ctl=ctl,
                       transition=env.transition)

        step_carry = _chunked(env, num_steps, regen_chunk, run, chunk_fn, seeds_for, collect=True)

        @torch.no_grad()
        def regen_rollout(weights: EvalWeights, key: torch.Tensor, carry: PackedCarry, mark=_no_mark, lane0=0,
                          total=None):
            carry, metrics, traj = step_carry((key, lane0, total), carry, mark, ctx=weights)
            return carry, traj, metrics

        return regen_rollout

    @torch.no_grad()
    def rollout(weights: EvalWeights, key: torch.Tensor, carry: PackedCarry, mark=_no_mark, lane0=0, total=None):
        b, dev = carry.words.shape[1], carry.words.device
        seeds = seeds_for((key, lane0, total), b, dev)
        mark("seeds")
        words_f, regs_f, rsum, epi, csum, traj = run(
            carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, seeds, weights, env.config, collect=True,
            transition=env.transition,
        )
        mark("collect")
        rng = carry.rng
        if mode == "regen":
            rng = _replay_rng_chain(env, rng, epi[0])
        mark("replay")
        carry = PackedCarry(words_f, regs_f, carry.tmpl_words, carry.tmpl_regs, rng)
        return carry, traj, rollout_metrics(rsum, epi, csum, num_steps)

    return rollout
