"""The actor-critic gradient pass over a spilled trajectory, in a
hand-written CUDA kernel, plus its plain version (counterpart of
`minigrid_tpu/ops/grad_kernel.py`).

For every (step, lane) sample: the forward of `policy_logits` from the
spilled obs words (bf16 torso, f32 head), the hand-derived cotangents of
the loss `(-Σ logp[a]·adv + vc·Σ (v - ret)² - ec·Σ entropy) / denom` on
the 8 head rows (log-softmax over the A action rows, the critic in row 7),
and the five backward products plus the bias grads, accumulated in f32
over all samples, and the loss sums `[pg_sum, v_sum, ent_sum]`.

`run_grad_kernel` runs `csrc/grad_kernel.cu` for CUDA tensors (or raises)
and `plain_grad_pass`, the same math step by step in torch ops, for CPU
tensors. Both return the f32 sums; `build_grad_kernel` rounds the torso
cotangents to bf16 as the JAX wrapper does (`.astype(w.wt1.dtype)`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from minigrid_tpu_torch.ops.fused_rollout import _SMEM_LIMIT
from minigrid_tpu_torch.ops.policy_rollout import (
    CHUNK_BYTES,
    HEAD_ROWS,
    HIDDEN,
    _BAR_BYTES,
    EvalWeights,
    _b_chunks,
    _check_operands,
    features,
    padded_features,
    ring_stages,
    torso,
)

LANE_BLOCK = 64  # lanes of a G1 block (one warpgroup); the kernel takes B in whole blocks
TIME_CHUNK = 8  # steps whose scratch G1 writes and G2 reads per launch pair
MAX_SPLITS = 64  # G2's splits of the lanes
G2_TILE = 128  # G2 output rows a block; its N is all 256 hidden units
G2_KSTEP = 64  # G2 samples a pipeline stage: 64 lanes of one step
PART_WIDTH = HEAD_ROWS * HIDDEN + 2 * HIDDEN + 2 * HEAD_ROWS  # G1 partial row
MAX_VIEW = 7  # a G2 stage holds one step's obs words of 64 lanes, V² ≤ 49
_TILE_STRIDE = LANE_BLOCK + 8  # elements per hidden row of G1's [256][64] tiles

# Launches of the CUDA gradient kernel in this process (plain integer; the
# wrapper adds one per launch of the G1/G2 pass and nowhere else).
grad_kernel_launches = 0


def _feats(wv: torch.Tensor) -> torch.Tensor:
    """(V², B) obs words (occlusion folded in as zeros) -> (V²·20, B) f32
    value-major one-hot rows."""
    return features(wv, 1)


def _head_cotangent(head, act, adv, ret, num_actions, inv_denom, value_coef, entropy_coef):
    """(8, B) head rows -> (dhead (8, B), pg, v, ent (B,) per-lane loss
    terms), term for term as the JAX kernel derives them."""
    a_n = num_actions
    m = head[0:1]
    for i in range(1, a_n):
        m = torch.maximum(m, head[i : i + 1])
    exps = [torch.exp(head[i : i + 1] - m) for i in range(a_n)]
    total = exps[0]
    for e in exps[1:]:
        total = total + e
    logz = torch.log(total) + m
    rows_dlp, p_rows = [], []
    ent = torch.zeros_like(m)
    pg = torch.zeros_like(m)
    for i in range(a_n):
        lp = head[i : i + 1] - logz
        p = exps[i] / total
        p_rows.append(p)
        onehot = (act == i).to(torch.float32)
        rows_dlp.append((-adv) * onehot * inv_denom + (-entropy_coef) * (-(p * (lp + 1.0))) * inv_denom)
        ent = ent - p * lp
        pg = pg - lp * onehot * adv
    s_dlp = rows_dlp[0]
    for r in rows_dlp[1:]:
        s_dlp = s_dlp + r
    zero = torch.zeros_like(m)
    dv = head[HEAD_ROWS - 1 : HEAD_ROWS] - ret
    rows = [rows_dlp[i] - p_rows[i] * s_dlp if i < a_n else zero for i in range(HEAD_ROWS - 1)]
    rows.append(float(np.float32(2.0 * value_coef)) * dv * inv_denom)
    return torch.cat(rows), pg[0], (dv * dv)[0], ent[0]


def plain_grad_pass(w: EvalWeights, obs_w, actions, adv, ret, num_actions: int, denom: float,
                    value_coef: float, entropy_coef: float):
    """The gradient pass as a loop of torch ops over the time steps, on any
    device: `(gw, sums)` with `gw` the f32 sums of the cotangents in the
    `EvalWeights` layout and `sums` the `(3,)` f32 `[pg_sum, v_sum,
    ent_sum]`. obs_w `(T, V², B)` int32, actions `(T, B)` int32, adv and
    ret `(T, B)` f32. Its f32 GEMMs take bf16 values, so each product is
    exact and only the order of the f32 sums differs from the kernel's;
    keep TF32 off on a card."""
    inv_denom = float(np.float32(1.0 / denom))
    wf = EvalWeights(*(x.float() for x in w))
    acc = [torch.zeros_like(x) for x in wf]
    sums = torch.zeros(3, dtype=torch.float32, device=obs_w.device)
    for t in range(obs_w.shape[0]):
        feats = _feats(obs_w[t])
        h1p, h2p = torso(feats, w)
        h1 = torch.relu(h1p).float()
        h2 = torch.relu(h2p).float()
        head = wf.wta @ h2 + wf.ba
        dhead, pg, v, ent = _head_cotangent(
            head, actions[t : t + 1], adv[t : t + 1], ret[t : t + 1], num_actions, inv_denom, value_coef,
            entropy_coef,
        )
        dh2 = torch.where(h2p > 0, wf.wta.T @ dhead, 0.0).to(torch.bfloat16).float()
        dh1 = torch.where(h1p > 0, wf.wt2.T @ dh2, 0.0).to(torch.bfloat16).float()
        for i, d in enumerate((
            dh1 @ feats.T, dh1.sum(1, keepdim=True), dh2 @ h1.T, dh2.sum(1, keepdim=True),
            dhead @ h2.T, dhead.sum(1, keepdim=True),
        )):
            acc[i] += d
        sums += torch.stack([pg.sum(), v.sum(), ent.sum()])
    return EvalWeights(*acc), sums


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------


def _g1_smem_without_ring(view: int) -> int:
    """G1's shared memory besides its ring, as `csrc/grad_kernel.cu::G1Smem`
    carves it: the ring's bookkeeping, dh2 as wgmma's A operand `[64][256]`
    in bf16, the head weights and biases in f32, the step's feature bits
    `[K/32][64]` in uint32, the `[256][72]` bf16 tiles of h1 (later dh1)
    and h2, dhead `[8][64]`, the lane sums `[3][64]` and the tile's running
    dwta, db1, db2 and dba in f32."""
    bt = LANE_BLOCK
    head = HEAD_ROWS * HIDDEN + 2 * HIDDEN + HEAD_ROWS
    return (
        _BAR_BYTES + bt * HIDDEN * 2 + head * 4 + padded_features(view) // 32 * bt * 4
        + 2 * HIDDEN * _TILE_STRIDE * 2 + (HEAD_ROWS + 3) * bt * 4 + head * 4
    )


def grad_plan(view: int):
    """`(stages, smem_bytes)` of a G1 block: its weight ring
    (`policy_rollout.ring_stages`) takes the shared memory left."""
    base = _g1_smem_without_ring(view)
    stages = ring_stages(_SMEM_LIMIT - base)
    if stages is None:
        raise ValueError(f"grad kernel: view {view} leaves no room for the weight ring")
    return stages, base + stages * CHUNK_BYTES


def grad_smem_bytes(view: int) -> int:
    """Dynamic shared memory of one G1 block (`grad_plan`)."""
    return grad_plan(view)[1]


def grad_splits(b: int):
    """(splits, lanes per split) of G2's K dimension: at most MAX_SPLITS,
    each a whole number of G2_KSTEP-lane stages."""
    splits = min(MAX_SPLITS, b // LANE_BLOCK)
    lanes = -(-b // splits // G2_KSTEP) * G2_KSTEP
    return -(-b // lanes), lanes


def g2_tiles(view: int):
    """(nf, dW1 tiles, dW2 tiles) of G2's grid: dW1ᵀ's V²·20 feature rows
    padded to `nf`, a whole number of G2_TILE-row tiles, then dW2's 256
    rows; every tile spans all 256 columns."""
    nf = -(-view * view * 20 // G2_TILE) * G2_TILE
    return nf, nf // G2_TILE, HIDDEN // G2_TILE


def _check_strided(name, t, shape, dtype, device):
    """A `(T, ..., B)` operand whose inner dims are contiguous; its time
    stride may be larger (a view of the spill)."""
    if t.dtype != dtype:
        raise TypeError(f"grad kernel: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"grad kernel: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t[0].is_contiguous() or t.stride(0) < t[0].numel():
        raise ValueError(f"grad kernel: {name} needs contiguous rows per step")
    if t.device != device:
        raise ValueError(f"grad kernel: {name} is on {t.device}, obs_w on {device}")


def run_grad_kernel(w: EvalWeights, obs_w, actions, adv, ret, num_actions: int, denom: float,
                    value_coef: float, entropy_coef: float):
    """The gradient kernel's wrapper: same arguments and results as
    `plain_grad_pass`. CPU tensors run `plain_grad_pass`; CUDA tensors
    launch the kernel on the current stream (every chunk's G1 and G2 in
    one call), and any other device, operand the kernel does not take,
    failed build or failed launch raises (operands first, then the
    device). obs_w and actions may be views of the trajectory spill."""
    if obs_w.device.type == "cpu":
        return plain_grad_pass(w, obs_w, actions, adv, ret, num_actions, denom, value_coef, entropy_coef)
    dev = obs_w.device
    t, v2, b = obs_w.shape
    view = int(round(v2**0.5))
    if view * view != v2 or view > MAX_VIEW:
        raise ValueError(f"grad kernel: {v2} view cells; the kernel takes a square view of at most {MAX_VIEW}")
    if not 1 <= num_actions < HEAD_ROWS:
        raise ValueError(f"grad kernel: {num_actions} actions; head row {HEAD_ROWS - 1} is the critic")
    if b == 0 or t == 0 or b % LANE_BLOCK:
        raise ValueError(f"grad kernel: the batch ({b}) must be a positive multiple of {LANE_BLOCK}, T ({t}) positive")
    _check_strided("obs_w", obs_w, (t, v2, b), torch.int32, dev)
    _check_strided("actions", actions, (t, b), torch.int32, dev)
    if obs_w.data_ptr() % 16 or obs_w.stride(0) % 4:
        raise ValueError("grad kernel: obs_w must start on 16 bytes with a time stride of whole 16-byte words")
    f_total = v2 * 20
    _check_operands((
        ("adv", adv, (t, b), torch.float32),
        ("ret", ret, (t, b), torch.float32),
        ("wt1", w.wt1, (HIDDEN, f_total), torch.bfloat16),
        ("b1", w.b1, (HIDDEN, 1), torch.bfloat16),
        ("wt2", w.wt2, (HIDDEN, HIDDEN), torch.bfloat16),
        ("b2", w.b2, (HIDDEN, 1), torch.bfloat16),
        ("wta", w.wta, (HEAD_ROWS, HIDDEN), torch.float32),
        ("ba", w.ba, (HEAD_ROWS, 1), torch.float32),
    ), dev)
    if dev.type != "cuda":
        raise ValueError(f"grad kernel: obs_w is on {dev}, expected a CUDA device")
    from minigrid_tpu_torch.ops import _build

    lib = _build.load_library(dev)
    # The weights in the ring's chunks (`policy_rollout._b_chunks`), made on
    # every call: W1ᵀ, W2ᵀ (layer 2's B) and W2 (the B of dh1).
    w1s = _b_chunks(w.wt1, True)
    w2s, w2ts = _b_chunks(w.wt2, False), _b_chunks(w.wt2.T, False)
    stages, smem = grad_plan(view)
    tc = min(TIME_CHUNK, t)
    nf, _, _ = g2_tiles(view)
    splits, split_lanes = grad_splits(b)
    scratch = torch.empty((3, tc, HIDDEN, b), dtype=torch.bfloat16, device=dev)  # h1, dh1, dh2
    part1 = torch.empty((b // LANE_BLOCK, PART_WIDTH), dtype=torch.float32, device=dev)
    dw1p = torch.empty((splits, nf, HIDDEN), dtype=torch.float32, device=dev)  # dW1ᵀ
    dw2p = torch.empty((splits, HIDDEN, HIDDEN), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_grad_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                obs_w, actions, adv, ret, w1s, w.b1, w2s, w.b2, w2ts, w.wta, w.ba,
                scratch[0], scratch[1], scratch[2], part1, dw1p, dw2p,
            )),
            obs_w.stride(0), actions.stride(0), b, t, view, num_actions, tc, nf, splits, split_lanes, stages,
            float(np.float32(1.0 / denom)), float(np.float32(2.0 * value_coef)), float(np.float32(entropy_coef)),
            smem, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"grad kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})")
    global grad_kernel_launches
    grad_kernel_launches += 1
    g1 = part1.sum(0)
    hw = HEAD_ROWS * HIDDEN
    gw = EvalWeights(
        wt1=dw1p.sum(0)[:f_total].T.contiguous(),
        b1=g1[hw : hw + HIDDEN, None],
        wt2=dw2p.sum(0),
        b2=g1[hw + HIDDEN : hw + 2 * HIDDEN, None],
        wta=g1[:hw].reshape(HEAD_ROWS, HIDDEN),
        ba=g1[hw + 2 * HIDDEN : hw + 2 * HIDDEN + HEAD_ROWS, None],
    )
    return gw, g1[hw + 2 * HIDDEN + HEAD_ROWS : hw + 2 * HIDDEN + HEAD_ROWS + 3]


def build_grad_kernel(view: int, num_actions: int, t_total: int, b: int, denom: float, value_coef: float,
                      entropy_coef: float):
    """`grads(w: EvalWeights, obs_w (T, V², B) i32, actions (T, B) i32, adv
    (T, B) f32, ret (T, B) f32) -> (gw: EvalWeights cotangents, sums (3,)
    f32 = [pg_sum, v_sum, ent_sum])`, as the JAX package's `build_grad_kernel`
    returns them: the f32 sums, the torso's rounded once to the weights'
    bf16. Its TPU tiling arguments have no counterpart here."""

    def grads(w: EvalWeights, obs_w, actions, adv, ret):
        shape = (t_total, view * view, b)
        if tuple(obs_w.shape) != shape:
            raise ValueError(f"grad kernel: obs_w has shape {tuple(obs_w.shape)}, built for {shape}")
        gw, sums = run_grad_kernel(w, obs_w, actions, adv, ret, num_actions, denom, value_coef, entropy_coef)
        return EvalWeights(*(g.to(x.dtype) for g, x in zip(gw, w))), sums

    return grads
