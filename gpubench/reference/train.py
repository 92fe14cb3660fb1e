"""Plain reference of the fused train step, and the judge of a trainer's
steps against it.

A step: `T` steps of every lane with the actor in the loop (the action
drawn by inverse CDF from the step key's seed stream), the discounted
returns, the actor-critic loss and its gradient over all `T·B` samples,
clipping and Adam. The reference follows the trainer's sampled actions
(its output, read to be judged) and replays the world under them; at each
step it draws its own action from its own float32 policy and counts where
the two differ. Imports nothing of the program."""

from __future__ import annotations

import torch

from gpubench.reference import minigrid as M
from gpubench.reference import policy as P


def digest(obs: torch.Tensor) -> torch.Tensor:
    """A per-lane digest of a `(T, V², B)` trajectory of views: the sum of
    each word weighted by its row and step, `(B,)` int64."""
    rows = torch.arange(1, obs.shape[1] + 1, device=obs.device)[:, None]
    out = torch.zeros(obs.shape[2], dtype=torch.int64, device=obs.device)
    for t in range(obs.shape[0]):
        out += (obs[t].long() * rows).sum(dim=0) * (t + 1)
    return out


def rollout(cfg: dict, state, params: dict, key: torch.Tensor, steps: int, actions=None,
            torso_dtype=torch.float32, head_dtype=torch.float32):
    """`steps` steps of every lane from `state` `(words, regs, tmpl_words,
    tmpl_regs, rng)` with the actor in the loop, following `actions`
    `(T, B)` where given. Returns `(trajectory dict, final state, the
    number of steps whose action is not the policy's own draw, the widest
    gap by which a step's uniform lies outside its action's interval of
    the policy's cumulative distribution)`."""
    words, regs, tw, tr, rng = state
    b, view = words.shape[1], cfg["view"]
    kw = dict(width=cfg["width"], height=cfg["height"], view=view, max_steps=cfg["max_steps"],
              see_through_walls=cfg["see_through_walls"])
    seeds = P.seeds(key, steps, b)
    dev = words.device
    traj = dict(obs=torch.empty((steps, view * view, b), dtype=torch.int16, device=dev),
                actions=torch.empty((steps, b), dtype=torch.int64, device=dev),
                value=torch.empty((steps, b), dtype=torch.float32, device=dev),
                reward=torch.empty((steps, b), dtype=torch.float32, device=dev),
                done=torch.empty((steps, b), dtype=torch.bool, device=dev))
    obs = M.observe(words, regs, kw["width"], kw["height"], view, kw["see_through_walls"])
    episodes = torch.zeros(b, dtype=torch.int64, device=dev)
    differ, gap = 0, 0.0
    with torch.no_grad():
        for t in range(steps):
            logits, value = P.forward(params, P.features(obs, view), torso_dtype, head_dtype)
            own = P.sample(logits, seeds[t])
            a = own if actions is None else actions[t].to(dev).long()
            differ += int((a != own).sum())
            gap = max(gap, float(P.cdf_gap(logits, seeds[t], a).max()))
            traj["obs"][t], traj["actions"][t], traj["value"][t] = obs, a, value
            words, regs, reward, done, obs = M.step(words, regs, a[None].int(), tw, tr, **kw)
            traj["reward"][t], traj["done"][t] = reward[0], done[0]
            episodes += done[0]
    if cfg["layouts"] != "static":
        raise ValueError("the train reference covers static layouts")
    for _ in range(int(episodes.max())):
        rng = torch.where((episodes > 0)[:, None], M.split(rng, 2)[:, 1], rng)
        episodes -= 1
    return traj, (words, regs, tw, tr, rng), differ, gap


def train_steps(cfg: dict, state, params0: dict, keys, steps: int, chunk: int, actions=None,
                torso_dtype=torch.float32, head_dtype=torch.float32, adam_state=None):
    """`len(keys)` train steps from `params0` and Adam's `adam_state`
    (`(mu, nu, count)`; default fresh), following the trainer's
    `actions[s]` where given. Returns per step `(trajectory, loss, clipped
    gradient)`, the final state and params, the actions that were not the
    policy's own draw, and the widest gap of a draw (`rollout`)."""
    params, adam, out, differ, gap = params0, P.Adam(params0, adam_state), [], 0, 0.0
    for s, key in enumerate(keys):
        traj, state, d, g = rollout(cfg, state, params, key, steps, None if actions is None else actions[s],
                                    torso_dtype, head_dtype)
        differ, gap = differ + d, max(gap, g)
        ret = P.returns(traj["reward"], traj["done"])
        loss, grads = P.loss_and_grads(params, traj["obs"], traj["actions"], ret, ret - traj["value"], cfg["view"],
                                       chunk, torso_dtype, head_dtype)
        params, clipped = adam.step(params, grads)
        out.append((traj, loss, clipped))
    return out, state, params, differ, gap


def _norms(tree):
    return {(n, k): float(tree[n][k].double().norm()) for n, k in P.LEAVES}


def leaf_gaps(got: dict, want: dict, keep=None, diff: bool = False) -> dict:
    """Each leaf's gap between two trees' norms (`diff`: the norm of their
    difference), against the larger of that leaf's reference norm and the
    median leaf's."""
    w = _norms(want)
    g = _norms({n: {k: got[n][k] - want[n][k] for k in want[n]} for n in want}) if diff else _norms(got)
    leaves = [x for x in P.LEAVES if keep is None or x in keep]
    med = sorted(w[x] for x in leaves)[len(leaves) // 2]
    return {x: (g[x] if diff else abs(g[x] - w[x])) / max(w[x], med, 1e-30) for x in leaves}


def leaf_gap(got: dict, want: dict, keep=None, diff: bool = False) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(got, want, keep, diff).values())


def judge(cfg: dict, start, params0: dict, keys, steps: int, chunk: int, trainer: dict, adam_state=None,
          dtypes=(torch.float32, torch.float32)) -> dict:
    """The trainer's steps from `start`, `params0` and `adam_state` (as in
    `train_steps`) against the reference following its actions.
    `trainer` holds per step `actions`, `reward`, `done` (`(T, B)`),
    `digest` (`(B,)`) and `loss`; then `grad` (the first step's clipped
    gradient as Adam received it), `params` (after the last step) and
    `state` (the world after it, `(words, regs, rng)`). The reference runs
    at `dtypes`, the torso's and the heads' (`forward`). A trainer whose
    trajectory is not of the batch's shape fails every number."""
    dev, b = start[0].device, start[0].shape[1]
    if any(tuple(x.shape) != (steps, b) for name in ("actions", "reward", "done") for x in trainer[name]):
        return dict(env_lanes_wrong=b, action_mismatch_pct=100.0, cdf_gap=1.0, loss_gap=float("inf"),
                    grad_gap=float("inf"), grad_diff=float("inf"), update_gap=float("inf"),
                    update_diff=float("inf"), actions_outside=0)
    out, state, params, differ, gap = train_steps(cfg, start, params0, keys, steps, chunk, trainer["actions"],
                                                  *dtypes, adam_state=adam_state)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    loss_gap = 0.0
    for s, (traj, loss, _) in enumerate(out):
        bad |= (traj["reward"] != trainer["reward"][s].to(dev)).any(0)
        bad |= (traj["done"] != trainer["done"][s].to(dev).bool()).any(0)
        bad |= digest(traj["obs"]) != trainer["digest"][s].to(dev)
        loss_gap = max(loss_gap, abs(trainer["loss"][s] - loss))
    for got, want in zip(trainer["state"], (state[0], state[1])):
        bad |= (got.to(dev) != want).any(0)
    bad |= (trainer["state"][2].to(dev) != state[4]).any(1)
    first = _norms(out[0][2])
    med = sorted(first.values())[len(first) // 2]
    moving = {x for x, v in first.items() if v >= 1e-3 * med}
    change = {n: {k: params[n][k] - params0[n][k] for k in params[n]} for n in params}
    got_change = {n: {k: trainer["params"][n][k].to(dev) - params0[n][k] for k in params[n]} for n in params}
    total = len(trainer["actions"]) * trainer["actions"][0].numel()
    outside = sum(int((a >= params0["actor"]["kernel"].shape[1]).sum()) for a in trainer["actions"])
    got_grad = {n: {k: v.to(dev) for k, v in trainer["grad"][n].items()} for n in trainer["grad"]}
    return dict(env_lanes_wrong=int(bad.sum()), action_mismatch_pct=100.0 * differ / total, cdf_gap=gap,
                loss_gap=loss_gap, actions_outside=outside, grad_gap=leaf_gap(got_grad, out[0][2]),
                grad_diff=leaf_gap(got_grad, out[0][2], diff=True), update_gap=leaf_gap(got_change, change, moving),
                update_diff=leaf_gap(got_change, change, moving, diff=True),
                grad_worst_leaf="/".join(max((v, x) for x, v in leaf_gaps(got_grad, out[0][2]).items())[1]))


def control(cfg: dict, start, params0: dict, keys, steps: int, chunk: int, torso_dtype, head_dtype,
            adam_state=None) -> dict:
    """The reference at lower precisions in the trainer's place: its own
    draws, losses and updates, in the form `judge` reads."""
    out, state, params, _, _ = train_steps(cfg, start, params0, keys, steps, chunk, None, torso_dtype, head_dtype,
                                           adam_state)
    return dict(actions=[o[0]["actions"] for o in out], reward=[o[0]["reward"] for o in out],
                done=[o[0]["done"] for o in out], digest=[digest(o[0]["obs"]) for o in out],
                loss=[o[1] for o in out], grad=out[0][2], params=params, state=(state[0], state[1], state[4]))
