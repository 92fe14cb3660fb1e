"""The fused train step on the steady carry surface (counterpart of the
parts of `minigrid_tpu/parallel/train.py` that
`build_fused_train_step` runs, on one device; sharding is not ported yet).

One `train_step(train_state, carry, key)` call:
  1. the policy kernel in collect mode (`build_fused_train_rollout`) runs
     T steps of every lane with the actor in the loop and spills the
     trajectory: obs words, actions, logp, the critic's value, rewards and
     done;
  2. the discounted returns and advantages (`_trajectory_returns`);
  3. the gradient pass over the trajectory: the hand-written CUDA kernel
     (`ops/grad_kernel.py::build_grad_kernel`) in the `EvalWeights` layout,
     whose cotangents are pulled back once through
     `train_weights_from_params` to the flax layout with autograd, as JAX
     does with `jax.vjp`;
  4. optax's `flatten(chain(clip_by_global_norm(0.5), adam(3e-4)))`, as
     plain torch ops on one flat f32 vector in `ravel_pytree`'s order.

CPU tensors take the plain versions of both kernels. `_trajectory_grads_packed`,
the JAX package's `grad_backend="xla"` pass, is here as torch autograd of
the same loss; it is the reference the kernel's pass is tested against.
The discount, the loss coefficients and the optimizer's settings are the
JAX package's defaults, as module constants.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import torch

from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops.grad_kernel import build_grad_kernel
from minigrid_tpu_torch.ops.policy_rollout import (
    EvalWeights,
    _no_mark,
    _params_tree,
    _tree_tensor,
    build_fused_train_rollout,
    policy_logits,
    train_weights_from_params,
)

GAMMA = 0.99
ENTROPY_COEF = 0.01
VALUE_COEF = 0.5
PACKED_TIME_CHUNK = 4  # steps a chunk of `_trajectory_grads_packed`
LR = 3e-4
MAX_GRAD_NORM = 0.5
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class TrainState(NamedTuple):
    """`params`: the `ActorCritic`; `opt_state`: the optimizer's
    `AdamState`. The train step leaves both as they are and returns new
    ones, as JAX's functional step does."""

    params: ActorCritic
    opt_state: "AdamState"


class AdamState(NamedTuple):
    """optax's `ScaleByAdamState` over the flat parameter vector:
    `count` a 0-d int32, `mu` and `nu` `(N,)` f32."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


class Optimizer(NamedTuple):
    """`init(flat_params) -> AdamState`; `update(flat_grads, state) ->
    (flat_updates, state)`."""

    init: Callable
    update: Callable


def make_model(env: Env, generator=None, device=None) -> ActorCritic:
    return ActorCritic(env.config.num_actions, view=env.config.agent_view_size, generator=generator, device=device)


def make_optimizer() -> Optimizer:
    """optax's `flatten(chain(clip_by_global_norm(0.5), adam(3e-4)))`, its
    operations in optax's order (`clipping.py`, `transform.py::
    scale_by_adam`): the clip is `g` below the norm, else `(g / norm) ·
    0.5` (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`)."""

    def init(flat: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros((), dtype=torch.int32, device=flat.device), torch.zeros_like(flat),
                         torch.zeros_like(flat))

    def update(g: torch.Tensor, state: AdamState):
        norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(norm < MAX_GRAD_NORM, g, (g / norm) * MAX_GRAD_NORM)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu
        count = state.count + 1
        c = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=g.device), c))
        nu_hat = nu / (1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=g.device), c))
        updates = (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)) * -LR
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def _flax_names(tree) -> list:
    """(layer, leaf) pairs in the order `jax.flatten_util.ravel_pytree`
    takes a flax params tree: sorted keys at each level."""
    p = tree["params"]
    return [(n, k) for n in sorted(p) for k in sorted(p[n])]


def flatten_params(tree) -> torch.Tensor:
    """A flax-layout params (or grads) tree of tensors -> one flat f32
    vector, kernels `(in, out)` row-major."""
    return torch.cat([tree["params"][n][k].reshape(-1) for n, k in _flax_names(tree)])


def _apply_updates(model: ActorCritic, flat: torch.Tensor) -> ActorCritic:
    """`optax.apply_updates`: a copy of `model` whose every parameter has
    gained its slice of the flat update vector (flax kernels `(in, out)`
    are `weight.T`); `model` stays as it is."""
    model = copy.deepcopy(model)
    tree = model.flax_params()
    off = 0
    with torch.no_grad():
        for n, k in _flax_names(tree):
            layer = getattr(model, n)
            size = tree["params"][n][k].numel()
            u = flat[off : off + size].reshape(tree["params"][n][k].shape)
            if k == "kernel":
                layer.weight.copy_(layer.weight + u.T)
            else:
                layer.bias.copy_(layer.bias + u)
            off += size
    return model


def init_train_state(env: Env, generator=None, device=None) -> TrainState:
    """A seeded `ActorCritic` (flax's initialisers; `generator` default: a
    generator seeded with 0 on `device`, itself the card by default) and
    the optimizer's zero state beside it."""
    model = make_model(env, generator, device)
    return TrainState(model, make_optimizer().init(flatten_params(model.flax_params())))


def _trajectory_returns(reward: torch.Tensor, done: torch.Tensor, gamma: float) -> torch.Tensor:
    """Discounted returns `(T, B)` f32, backward over the time axis:
    `ret_t = r_t + gamma · (1 - done_t) · ret_{t+1}`, in that order."""
    not_done = 1.0 - done.to(torch.float32)
    out = torch.empty_like(reward)
    carry = torch.zeros_like(reward[0])
    for t in range(reward.shape[0] - 1, -1, -1):
        carry = reward[t] + gamma * not_done[t] * carry
        out[t] = carry
    return out


def _fit_time_chunk(num_steps: int, target: int) -> int:
    tc = min(target, num_steps)
    while num_steps % tc:
        tc -= 1
    return tc


class _TrainWeights(NamedTuple):
    """The train-layout weights of a params tree under autograd: `leaves`
    is a flax-layout tree of fresh f32 leaves that require grad, `w` is
    `train_weights_from_params(leaves)`, whose graph leads back to them.
    One step builds them once: the rollout and the gradient pass read `w`
    outside autograd and the pullback reuses its graph."""

    leaves: dict
    w: EvalWeights


def _train_weights(params, view: int, device=None) -> _TrainWeights:
    p, device = _params_tree(params, device)
    leaves = {"params": {
        n: {k: _tree_tensor(v, device).detach().clone().requires_grad_(True) for k, v in layer.items()}
        for n, layer in p.items()
    }}
    return _TrainWeights(leaves, train_weights_from_params(leaves, view))


def _pullback(tw: _TrainWeights, cotangents: EvalWeights):
    """The cotangents of `tw.w` pulled back to a flax-layout grads tree of
    f32 tensors (the transpose of the linear layout change, each bf16
    cast's adjoint the cast back to f32)."""
    names = _flax_names(tw.leaves)
    grads = torch.autograd.grad(list(tw.w), [tw.leaves["params"][n][k] for n, k in names], list(cotangents))
    out = {"params": {n: {} for n, _ in names}}
    for (n, k), g in zip(names, grads):
        out["params"][n][k] = g
    return out


def _metrics(sums, denom, reward, done):
    pg_loss, v_loss, ent = sums[0] / denom, sums[1] / denom, sums[2] / denom
    return {
        "loss": pg_loss + VALUE_COEF * v_loss - ENTROPY_COEF * ent,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "reward_per_step": torch.mean(reward),
        "episodes": torch.sum(done.to(torch.float32)),
    }


def _trajectory_grads_packed(tw: _TrainWeights, traj, view, num_actions):
    """The JAX package's `grad_backend="xla"` pass as torch autograd: the
    loss of each `PACKED_TIME_CHUNK` steps is differentiated with respect
    to the `EvalWeights` (bf16 torso, f32 head) and the chunk cotangents
    are accumulated in those dtypes (the torso's in bf16, as JAX's
    `zeros_like(w0)` is), then pulled back once to the flax layout.
    Returns `(grads tree, metrics)`."""
    obs_w, actions, _logp, value, reward, done = traj
    t_total, b = reward.shape
    tc = _fit_time_chunk(t_total, PACKED_TIME_CHUNK)
    returns = _trajectory_returns(reward, done, GAMMA)
    adv = returns - value
    denom = float(t_total * b)
    w = [x.detach().requires_grad_(True) for x in tw.w]
    gw = [torch.zeros_like(x) for x in w]
    sums = torch.zeros(3, dtype=torch.float32, device=obs_w.device)
    for c0 in range(0, t_total, tc):
        pg_sum = v_sum = ent_sum = 0.0
        for s in range(c0, c0 + tc):
            wv = obs_w[s]
            head = policy_logits(wv, torch.ones_like(wv), EvalWeights(*w), view)
            logp_all = torch.log_softmax(head[:num_actions], dim=0)
            logp = torch.gather(logp_all, 0, actions[s][None].long())[0]
            entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=0)
            pg_sum = pg_sum - torch.sum(logp * adv[s])
            v_sum = v_sum + torch.sum((head[7] - returns[s]) ** 2)
            ent_sum = ent_sum + torch.sum(entropy)
        loss = (pg_sum + VALUE_COEF * v_sum - ENTROPY_COEF * ent_sum) / denom
        g = torch.autograd.grad(loss, w)
        gw = [a + x for a, x in zip(gw, g)]
        sums = sums + torch.stack([pg_sum, v_sum, ent_sum]).detach()
    return _pullback(tw, EvalWeights(*gw)), _metrics(sums, denom, reward, done)


def _trajectory_grads_kernel(tw: _TrainWeights, traj, view, num_actions, mark=_no_mark):
    """`_trajectory_grads_packed` through the gradient kernel
    (`build_grad_kernel`): its f32 cotangent sums, the torso's rounded once
    to bf16 as the JAX wrapper rounds them, pulled back to the flax
    layout. Returns `(grads tree, metrics)`; `mark` as in `train_step`."""
    obs_w, actions, _logp, value, reward, done = traj
    t_total, b = reward.shape
    returns = _trajectory_returns(reward, done, GAMMA)
    adv = returns - value
    mark("returns")
    denom = float(t_total * b)
    gk = build_grad_kernel(view, num_actions, t_total, b, denom, VALUE_COEF, ENTROPY_COEF)
    gw, sums = gk(EvalWeights(*(x.detach() for x in tw.w)), obs_w, actions, adv, returns)
    mark("grad")
    grads = _pullback(tw, gw)
    mark("pullback")
    return grads, _metrics(sums, denom, reward, done)


def build_fused_train_step(env: Env, num_steps: int, mode: str = "cached", regen_chunk: int = 32):
    """`train_step(train_state, carry, key) -> (train_state, carry,
    metrics)` over a steady `PackedCarry` (`packed_init(env, states,
    mode)`): the collecting policy kernel, the returns, the gradient
    kernel, the pullback and clip + Adam, all on the carry's device (the
    plain versions of both kernels for CPU tensors).

    The returned state holds a new module and optimizer state; the one
    passed in is left as it was. `metrics` holds `loss`, `pg_loss`,
    `v_loss`, `entropy`, `reward_per_step`, `episodes` and `env_steps`, as
    0-d tensors. Cached mode, and regen: on a random layout (KeyCorridor,
    MultiRoom) every reset during training installs a fresh layout,
    through exact chunked regen with passes of `regen_chunk` steps
    (`build_fused_train_rollout`).

    `mark`, if given, is called with each piece's name as the host reaches
    its end ("weights", then the rollout's pieces — "seeds", "collect",
    "replay", or on a random layout chunked regen's "actions", "kernel",
    "refresh", "reentry", "sums" — then "returns", "grad", "pullback",
    "optimizer"); `tools/profile_step_torch.py --train` records a CUDA
    event there."""
    roll = build_fused_train_rollout(env, num_steps, mode=mode, regen_chunk=regen_chunk)
    optimizer = make_optimizer()
    view = env.config.agent_view_size

    def train_step(train_state: TrainState, carry, key: torch.Tensor, mark=_no_mark):
        tw = _train_weights(train_state.params, view, carry.words.device)
        mark("weights")
        carry, traj, roll_metrics = roll(tw.w, key, carry, mark)  # under no_grad
        grads, metrics = _trajectory_grads_kernel(tw, traj, view, env.config.num_actions, mark)
        updates, opt_state = optimizer.update(flatten_params(grads), train_state.opt_state)
        params = _apply_updates(train_state.params, updates)
        mark("optimizer")
        metrics = dict(metrics, env_steps=roll_metrics.total_steps)
        return TrainState(params, opt_state), carry, metrics

    return train_step
