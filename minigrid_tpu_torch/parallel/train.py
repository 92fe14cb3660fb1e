"""The train steps (counterpart of `minigrid_tpu/parallel/train.py`), on
one device or over a mesh (`parallel/sharding.py`).

Three steps, each `train_step(train_state, states or carry, key) ->
(train_state, states or carry, metrics)`:

  * `build_train_step`: the per-env engine (`core/autoreset.py`) with the
    `ActorCritic` in the loop, actions from `jax.random.categorical(key_t,
    logits)` (`prng.categorical_logits`), `key_t` from `split(key, T)`;
    gradients by autograd through the module, accumulated over time chunks
    (`_trajectory_grads`);
  * `build_packed_train_step`: the same loop on the packed step
    (`ops/fused_rollout.py::step_core` with its view), on a random layout
    with a template refresh after every 32-step chunk; the same gradient
    pass, so on one trajectory the two give the same update. The JAX
    package runs this step as plain XLA with no Pallas kernel, and so it is
    plain PyTorch here on every device;
  * `build_fused_train_step`, the fast path:
    1. the policy kernel in collect mode (`build_fused_train_rollout`) runs
       T steps of every lane with the actor in the loop and spills the
       trajectory: obs words, actions, logp, the critic's value, rewards and
       done;
    2. the discounted returns and advantages (`_trajectory_returns`);
    3. the gradient pass over the trajectory: the hand-written CUDA kernel
       (`ops/grad_kernel.py`) in the `EvalWeights` layout, whose cotangents
       are pulled back once through `train_weights_from_params` to the flax
       layout with autograd, as JAX does with `jax.vjp`;
  then optax's `flatten(chain(clip_by_global_norm(0.5), adam(3e-4)))`, as
  plain torch ops on one flat f32 vector in `ravel_pytree`'s order.

Over a mesh the three steps are, as in the JAX package (`jax.jit` with
shardings), the unsharded program on the whole batch: each shard steps its
lanes with the draws those lanes take in the whole batch (the categorical's
words of its rows, the fused step's seed columns), each shard's loss sums
are divided by the whole batch's `T·B`, the per-shard gradient sums are
added on the first shard's device in shard order (and across processes by
`all_reduce`, `parallel/distributed.py`), and one clip + Adam update runs
there. Only the order of float sums depends on the mesh.

CPU tensors take the plain versions of both kernels. `_trajectory_grads_packed`,
the JAX package's `grad_backend="xla"` pass, is here as torch autograd of
the same loss; it is the reference the kernel's pass is tested against.
The discount, the loss coefficients and the optimizer's settings are the
JAX package's defaults, as module constants.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.autoreset import make_autoreset_step
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops import grad_kernel as grad_ops
from minigrid_tpu_torch.ops.chunked_regen import masked_template_refresh, refresh_block_size
from minigrid_tpu_torch.ops.fused_rollout import (
    PackedCarry,
    _fit_chunk,
    _regen_is_static,
    _replay_rng_chain,
    fused_rollout_supported,
    hook_kwargs,
    obs_core,
    packed_finish,
    packed_init,
    step_core,
)
from minigrid_tpu_torch.ops.packed_gen import packed_generator
from minigrid_tpu_torch.ops.packing import R_RNG, rows_key
from minigrid_tpu_torch.ops.policy_rollout import (
    EvalWeights,
    _no_mark,
    _params_tree,
    _tree_tensor,
    build_fused_train_rollout,
    obs_words_to_images,
    pack_obs_words,
    policy_logits,
    train_weights_from_params,
)
from minigrid_tpu_torch.parallel import sharding
from minigrid_tpu_torch.parallel.sharding import Mesh, make_env_mesh, replicated

GAMMA = 0.99
ENTROPY_COEF = 0.01
VALUE_COEF = 0.5
PACKED_TIME_CHUNK = 4  # steps a chunk of `_trajectory_grads_packed` and `_trajectory_grads`
REFRESH_CHUNK = 32  # steps between the packed train step's template refreshes on a random layout
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


def init_train_state(env: Env, generator=None, device=None, mesh: Optional[Mesh] = None) -> TrainState:
    """A seeded `ActorCritic` (flax's initialisers; `generator` default: a
    generator seeded with 0 on `device`, itself the card by default) and
    the optimizer's zero state beside it. With a mesh, on its first
    shard's device, where the train steps update it (they replicate the
    weights to the other shards' devices on every step)."""
    if mesh is not None:
        first = mesh.shard_devices[0]
        if device is not None and torch.device(device) != first:
            raise ValueError(f"device {device} is not the mesh's first device {first}")
        device = first
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


def _metrics(sums, denom, reward_sum, episodes):
    """The step's metrics from its loss sums `(3,)`, `denom = T·B` and its
    f32 reward sum and episode count."""
    pg_loss, v_loss, ent = sums[0] / denom, sums[1] / denom, sums[2] / denom
    return {
        "loss": pg_loss + VALUE_COEF * v_loss - ENTROPY_COEF * ent,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "reward_per_step": reward_sum / denom,
        "episodes": episodes,
    }


def _traj_totals(reward, done):
    """A trajectory's f32 reward sum and episode count."""
    return torch.sum(reward), torch.sum(done.to(torch.float32))


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
    return _pullback(tw, EvalWeights(*gw)), _metrics(sums, denom, *_traj_totals(reward, done))


def _kernel_grad_sums(w: EvalWeights, traj, num_actions: int, denom: float, mark=_no_mark):
    """The gradient kernel over one trajectory (`grad_kernel.run_grad_kernel`,
    its plain version on the CPU), each loss term divided by `denom`:
    `(gw, sums, reward_sum, episodes)` with `gw` the f32 cotangent sums in
    the `EvalWeights` layout and `sums` the `(3,)` f32 loss sums. `mark`
    as in `train_step` ("returns")."""
    obs_w, actions, _logp, value, reward, done = traj
    returns = _trajectory_returns(reward, done, GAMMA)
    adv = returns - value
    mark("returns")
    gw, sums = grad_ops.run_grad_kernel(EvalWeights(*(x.detach() for x in w)), obs_w, actions, adv, returns,
                                        num_actions, denom, VALUE_COEF, ENTROPY_COEF)
    return (gw, sums, *_traj_totals(reward, done))


def _round_cotangents(tw: _TrainWeights, gw: EvalWeights) -> EvalWeights:
    """f32 cotangent sums rounded once to the weights' dtypes (the torso's
    to bf16), as the JAX package's kernel wrapper returns them."""
    return EvalWeights(*(g.to(x.dtype) for g, x in zip(gw, tw.w)))


def _trajectory_grads_kernel(tw: _TrainWeights, traj, view, num_actions, mark=_no_mark):
    """`_trajectory_grads_packed` through the gradient kernel
    (`grad_kernel.run_grad_kernel`): its f32 cotangent sums, the torso's
    rounded once to bf16 as the JAX wrapper rounds them, pulled back to the
    flax layout. Returns `(grads tree, metrics)`; `mark` as in `train_step`."""
    t_total, b = traj[4].shape
    denom = float(t_total * b)
    gw, sums, reward_sum, episodes = _kernel_grad_sums(tw.w, traj, num_actions, denom, mark)
    mark("grad")
    grads = _pullback(tw, _round_cotangents(tw, gw))
    mark("pullback")
    return grads, _metrics(sums, denom, reward_sum, episodes)


def _add_in_order(parts, device):
    """Per-shard tensors (or tuples of them) added in shard order on
    `device`."""
    total = parts[0]
    for p in parts[1:]:
        total = [a + b.to(device) for a, b in zip(total, p)] if isinstance(total, (list, tuple)) else (
            total + p.to(device))
    return total


def _global_sum(tensors, mesh: Mesh):
    """The sum over the job's processes of each tensor (in place, by
    `all_reduce`), where the mesh spans more than this process."""
    if mesh.n_global > mesh.n_env:
        from minigrid_tpu_torch.parallel.distributed import all_reduce_sum

        all_reduce_sum(tensors)
    return tensors


def _check_shards(values, mesh: Mesh, lanes_of) -> int:
    """Each shard's lanes (equal over the shards), after checking that
    there is one value per env shard."""
    if len(values) != mesh.n_env:
        raise ValueError(f"{len(values)} shards for a mesh of {mesh.n_env} env shards")
    widths = {lanes_of(v) for v in values}
    if len(widths) != 1:
        raise ValueError(f"the shards hold different lane counts {sorted(widths)}")
    return widths.pop()


def _model_grad_sums(model: ActorCritic, traj, denom: float, time_chunk: int = PACKED_TIME_CHUNK):
    """The gradient of the actor-critic loss over an `(obs images (T, B, V,
    V, 3), actions, logp, value, reward, done)` trajectory, each term
    divided by `denom`, by autograd through `model` (the JAX package's
    `_trajectory_grads`): the loss of every `time_chunk` steps is
    differentiated alone and the f32 gradients are accumulated in chunk
    order. Returns `(grads, sums, reward_sum, episodes)`: `grads` a flax
    params tree of f32 tensors, `sums` the `(3,)` f32 `[pg_sum, v_sum,
    ent_sum]`; `model` is left as it was."""
    obs, actions, _logp, value, reward, done = traj
    t_total = reward.shape[0]
    tc = _fit_time_chunk(t_total, time_chunk)
    returns = _trajectory_returns(reward, done, GAMMA)
    adv = returns - value
    names = [n for n, _ in model.named_parameters()]
    leaves = [p.detach().clone().requires_grad_(True) for _, p in model.named_parameters()]
    acc = [torch.zeros_like(x) for x in leaves]
    sums = torch.zeros(3, dtype=torch.float32, device=reward.device)
    for c0 in range(0, t_total, tc):
        c = slice(c0, c0 + tc)
        logits, value_now = torch.func.functional_call(model, dict(zip(names, leaves)), (obs[c],))
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1, actions[c, :, None].long())[..., 0]
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        pg_sum = -torch.sum(logp * adv[c])
        v_sum = torch.sum((value_now - returns[c]) ** 2)
        ent_sum = torch.sum(entropy)
        loss = (pg_sum + VALUE_COEF * v_sum - ENTROPY_COEF * ent_sum) / denom
        acc = [a + g for a, g in zip(acc, torch.autograd.grad(loss, leaves))]
        sums = sums + torch.stack([pg_sum, v_sum, ent_sum]).detach()
    grads = {"params": {}}
    for name, g in zip(names, acc):
        layer, kind = name.split(".")
        grads["params"].setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = g.T if kind == "weight" else g
    return (grads, sums, *_traj_totals(reward, done))


def _trajectory_grads(model: ActorCritic, traj, time_chunk: int = PACKED_TIME_CHUNK):
    """Parameter gradients and metrics of the actor-critic loss over a
    trajectory with `(T, B)` leading axes (`_model_grad_sums` over `T·B`),
    shared by `build_train_step` and `build_packed_train_step`, so their
    updates are the same given the same trajectory. Returns `(grads tree,
    metrics)`."""
    t_total, b = traj[4].shape
    denom = float(t_total * b)
    grads, sums, reward_sum, episodes = _model_grad_sums(model, traj, denom, time_chunk)
    return grads, _metrics(sums, denom, reward_sum, episodes)


def _act(model: ActorCritic, img: torch.Tensor, key_t: torch.Tensor, lane0: int):
    """One step of the actor: `(actions (B,) int32, logp, value)` on `(B, V,
    V, 3)` observations, the actions `jax.random.categorical(key_t,
    logits)` of lanes `lane0` onwards of the whole batch."""
    with torch.no_grad():
        logits, value = model(img)
    actions = prng.categorical_logits(key_t, logits, lane0)
    logp = torch.gather(torch.log_softmax(logits, dim=-1), 1, actions[:, None])[:, 0]
    return actions.to(torch.int32), logp, value


def _stack(steps):
    """Per-step tuples -> one tuple of `(T, ...)` tensors."""
    return tuple(torch.stack(x) for x in zip(*steps))


def _mesh_train_step(mesh: Optional[Mesh], num_steps: int, rollout, lanes_of, time_chunk: int):
    """A train step over the mesh (or, without one, one shard on the
    input's device) from a per-shard `rollout(model, value, key, lane0) ->
    (value, traj)`: every shard's lanes, then `_model_grad_sums` over the
    whole batch's `T·B`, the sums added in shard order on the first shard's
    device (and across processes), one clip + Adam update there."""
    optimizer = make_optimizer()

    def train_step(train_state: TrainState, values, key: torch.Tensor):
        shards = values if mesh is not None else (values,)
        m = mesh or make_env_mesh([lanes_of(shards[0])[1]])
        b = _check_shards(shards, m, lambda v: lanes_of(v)[0])
        total = b * m.n_global
        denom = float(num_steps * total)
        dev0 = m.shard_devices[0]
        models = dict(zip(m.shard_devices, replicated(train_state.params, m)))

        def shard(i):
            dev = m.shard_devices[i]
            value, traj = rollout(models[dev], shards[i], key.to(dev), (m.shard_offset + i) * b)
            return (value,) + _model_grad_sums(models[dev], traj, denom, time_chunk)

        out = sharding.map_shards(m, shard)
        grads = _add_in_order([flatten_params(o[1]) for o in out], dev0)
        sums = _add_in_order([o[2] for o in out], dev0)
        scalars = _add_in_order([torch.stack([o[3], o[4]]) for o in out], dev0)
        _global_sum([grads, sums, scalars], m)
        updates, opt_state = optimizer.update(grads, train_state.opt_state)
        new_state = TrainState(_apply_updates(train_state.params, updates), opt_state)
        finals = tuple(o[0] for o in out)
        return new_state, finals if mesh is not None else finals[0], _metrics(sums, denom, scalars[0], scalars[1])

    return train_step


def build_train_step(env: Env, num_steps: int, mesh: Optional[Mesh] = None, mode: str = "regen",
                     time_chunk: int = PACKED_TIME_CHUNK):
    """`train_step(train_state, states, key) -> (train_state, states,
    metrics)` on the per-env engine (the JAX package's `build_train_step`):
    T steps of `make_autoreset_step(env, mode)` with the `ActorCritic` in
    the loop, step t's actions `jax.random.categorical(split(key, T)[t],
    logits)` on the observation the step before returned; then
    `_trajectory_grads` and clip + Adam. `states` is a batched `EnvState`
    on one device, or with a mesh a sharded one
    (`sharding.shard_states`), and the step is the unsharded one on the
    whole batch (module docstring). The state passed in is left as it
    was; `metrics` holds `loss`, `pg_loss`, `v_loss`, `entropy`,
    `reward_per_step` and `episodes`."""
    auto_step = make_autoreset_step(env, mode=mode)

    def rollout(model, states, key, lane0):
        keys = prng.split(key, num_steps)
        img = env.observe(states, env.config)["image"]
        steps = []
        for t in range(num_steps):
            actions, logp, value = _act(model, img, keys[t], lane0)
            states, obs, reward, terminated, truncated = auto_step(states, actions)
            steps.append((img, actions, logp, value, reward, terminated | truncated))
            img = obs["image"]
        return states, _stack(steps)

    return _mesh_train_step(mesh, num_steps, rollout, lambda s: (s.step_count.shape[0], s.step_count.device),
                            time_chunk)


def build_packed_train_step(env: Env, num_steps: int, mesh: Optional[Mesh] = None, mode: str = "regen",
                            as_carry: bool = False, time_chunk: int = PACKED_TIME_CHUNK):
    """`build_train_step` on the packed step (the JAX package's
    `build_packed_train_step`): the same contract, update math and
    categorical draws, the env in the packed `(H·W, B)` / `(NUM_REGS, B)`
    layout, `step_core(..., with_obs=True)` giving each step's view, which
    becomes the policy's `(B, V, V, 3)` input. On the families where both
    run, the two steps give the same update. With `as_carry=True` the step
    takes and returns a `PackedCarry` (`packed_init` / `packed_finish`), or
    over a mesh a sharded one.

    In regen mode on a random layout every lane's template is refreshed
    after each chunk of `REFRESH_CHUNK` steps (the largest divisor of T up
    to it), as the JAX package does (`train.py:455-530`): only the lanes
    that reset in the chunk, their reset chain advanced by the resets they
    took; a lane that resets twice in a chunk reuses the chunk's template,
    that surface's documented approximation of regen. The template refresh
    runs the generation kernels on a CUDA carry. Elsewhere this step is
    plain PyTorch on every device, as the JAX package's is plain XLA.
    Raises where `fused_rollout_supported` is false."""
    if not fused_rollout_supported(env, mode=mode):
        raise ValueError(f"packed train step (mode={mode!r}) does not support {env.env_id!r}; use build_train_step")
    cfg = env.config
    view = cfg.agent_view_size
    geom = dict(width=cfg.width, height=cfg.height, view=view, see_through_walls=cfg.see_through_walls)
    hooks = hook_kwargs(env.transition, cfg)
    refresh = mode == "regen" and not _regen_is_static(env)
    tc = _fit_chunk(num_steps, REFRESH_CHUNK) if refresh else num_steps
    generate = packed_generator(env)

    def image(vw, vis):
        return obs_words_to_images(pack_obs_words(vw, vis), view)

    def rollout_packed(model, pc: PackedCarry, key, lane0):
        keys = prng.split(key, num_steps)
        words, regs, rng = pc.words, pc.regs, pc.rng
        tw, tr = (pc.tmpl_words.clone(), pc.tmpl_regs.clone()) if refresh else (pc.tmpl_words, pc.tmpl_regs)
        img = image(*obs_core(words, regs, **geom))
        steps = []
        for c0 in range(0, num_steps, tc):
            for t in range(c0, c0 + tc):
                actions, logp, value = _act(model, img, keys[t], lane0)
                words, regs, reward, done, _, vw, vis = step_core(
                    words, regs, actions[None, :], tw, tr, max_steps=cfg.max_steps, with_obs=True, **geom, **hooks
                )
                steps.append((img, actions, logp, value, reward[0], done[0]))
                img = image(vw, vis)
            if refresh:
                epi = torch.stack([s[5] for s in steps[c0:]]).sum(0, dtype=torch.int64)
                consumed = epi >= 1
                rng = torch.where(consumed[:, None], rows_key(tr[R_RNG : R_RNG + 2]), rng)
                rng = _replay_rng_chain(env, rng, torch.clamp(epi - 1, min=0))
                masked_template_refresh(env, tw, tr, rng, consumed, refresh_block_size(rng.shape[0]), generate)
        traj = _stack(steps)
        if mode == "regen" and not refresh:
            rng = _replay_rng_chain(env, rng, traj[5].sum(0, dtype=torch.int64))
        return PackedCarry(words, regs, tw, tr, rng), traj

    def rollout_states(model, states, key, lane0):
        pc, traj = rollout_packed(model, packed_init(env, states, mode), key, lane0)
        return packed_finish(env, pc), traj

    if as_carry:
        return _mesh_train_step(mesh, num_steps, rollout_packed, lambda c: (c.words.shape[1], c.words.device),
                                time_chunk)
    return _mesh_train_step(mesh, num_steps, rollout_states, lambda s: (s.step_count.shape[0], s.step_count.device),
                            time_chunk)


def build_fused_train_step(env: Env, num_steps: int, mode: str = "cached", regen_chunk: int = 32,
                           mesh: Optional[Mesh] = None):
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

    With a mesh the carry is a sharded `PackedCarry` (one per env shard,
    `parallel/packed.py::shard_carry`) and the step is the unsharded one on
    the whole batch (module docstring): shard `i` collects its lanes with
    the columns of the whole batch's `(T, B)` seed stream, runs the
    gradient kernel on its trajectory with the loss over the whole batch's
    `T·B`, and the f32 sums are added in shard order on the first shard's
    device, rounded and pulled back once there. The train state lives on
    that device (`init_train_state(..., mesh=mesh)`). Without a mesh the
    step runs the same code over one shard on the carry's device.

    `mark`, if given, is called with each piece's name as the host reaches
    its end ("weights", then on one shard the rollout's pieces — "seeds",
    "collect", "replay", or on a random layout chunked regen's "actions",
    "kernel", "refresh", "reentry", "sums" — and "returns"; then "grad",
    "pullback", "optimizer"; over several shards the shards' pieces are not
    marked and "grad" closes them all); `tools/profile_step_torch.py
    --train` records a CUDA event there."""
    roll = build_fused_train_rollout(env, num_steps, mode=mode, regen_chunk=regen_chunk)
    optimizer = make_optimizer()
    view = env.config.agent_view_size
    num_actions = env.config.num_actions

    def train_step(train_state: TrainState, carries, key: torch.Tensor, mark=_no_mark):
        m = mesh or make_env_mesh([carries.words.device])
        shards = carries if mesh is not None else (carries,)
        b = _check_shards(shards, m, lambda c: c.words.shape[1])
        total = b * m.n_global
        denom = float(num_steps * total)
        dev0 = m.shard_devices[0]
        tw = _train_weights(train_state.params, view, dev0)
        weights = dict(zip(m.shard_devices, replicated(EvalWeights(*(x.detach() for x in tw.w)), m)))
        mark("weights")
        shard_mark = mark if m.n_env == 1 else _no_mark

        def shard(i):
            dev = m.shard_devices[i]
            carry, traj, rm = roll(weights[dev], key.to(dev), shards[i], shard_mark, lane0=(m.shard_offset + i) * b,
                                   total=total)
            return (carry, rm.total_steps) + _kernel_grad_sums(weights[dev], traj, num_actions, denom, shard_mark)

        out = sharding.map_shards(m, shard)
        gw = _add_in_order([o[2] for o in out], dev0)
        scalars = _add_in_order([torch.stack([o[4], o[5]]) for o in out], dev0)
        sums = _add_in_order([o[3] for o in out], dev0)
        steps = _add_in_order([o[1] for o in out], dev0)
        _global_sum(list(gw) + [sums, scalars, steps], m)
        mark("grad")
        grads = _pullback(tw, _round_cotangents(tw, EvalWeights(*gw)))
        mark("pullback")
        updates, opt_state = optimizer.update(flatten_params(grads), train_state.opt_state)
        params = _apply_updates(train_state.params, updates)
        mark("optimizer")
        metrics = dict(_metrics(sums, denom, scalars[0], scalars[1]), env_steps=steps)
        finals = tuple(o[0] for o in out)
        return TrainState(params, opt_state), finals if mesh is not None else finals[0], metrics

    return train_step
