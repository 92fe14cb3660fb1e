"""Plain reference of the actor-critic and its training update: the
network of gym-minigrid's usual agents as the ported package defines it
(one-hot `(type, colour, state)` features of the 7 x 7 view, a 256 -> 256
ReLU torso, an actor and a critic head), its sampling, the actor-critic
loss, gradient clipping and Adam. Its products run in float32 with TF32
off; `forward` rounds the layers to the precisions it is given, as the
ported model does (bf16 operands, float32 sums rounded to bf16, bf16 bias
adds, float32 heads).

Parameters are a flax-layout tree: `{"torso_0": {"kernel": (980, 256),
"bias": (256,)}, "torso_1": ..., "actor": ..., "critic": ...}`. A view
cell `(row j, col i)` feeds features `(i·V + j)·20 + offset + value`, the
offsets of the three channels 0, 11 and 17. Imports nothing of the
program."""

from __future__ import annotations

import math

import torch

from gpubench.reference.minigrid import MASK32, threefry2x32

WIDTHS = (11, 6, 3)  # object types, colours, door states
OFFSETS = (0, 11, 17)
FEATURES = 20
SALT = 0x243F6A88  # the second key word of the sampling stream
GAMMA, ENTROPY_COEF, VALUE_COEF = 0.99, 0.01, 0.5
LR, MAX_GRAD_NORM, B1, B2, EPS = 3e-4, 0.5, 0.9, 0.999, 1e-8
LEAVES = [(n, k) for n in ("actor", "critic", "torso_0", "torso_1") for k in ("bias", "kernel")]


def _base(view: int, device) -> torch.Tensor:
    k = torch.arange(view * view, device=device)
    return ((k % view) * view + k // view) * FEATURES


def features(obs: torch.Tensor, view: int) -> torch.Tensor:
    """`(V², N)` view words -> `(N, V²·20)` f32 one-hot features; a value
    outside its channel's width sets none."""
    n = obs.shape[1]
    base = _base(view, obs.device)[:, None]
    x = torch.zeros((n, view * view * FEATURES + 1), dtype=torch.float32, device=obs.device)
    for c, (width, off) in enumerate(zip(WIDTHS, OFFSETS)):
        v = (obs.long() >> (4 * c)) & 15
        idx = torch.where(v < width, base + off + v, view * view * FEATURES)
        x.scatter_(1, idx.T, 1.0)
    return x[:, :-1]


def _q(x: torch.Tensor, dtype) -> torch.Tensor:
    """`x` rounded to `dtype` and back; the gradient passes the rounding
    unchanged, as the adjoint of a cast is the cast back."""
    return x if dtype == torch.float32 else x + (x.to(dtype).float() - x).detach()


def forward(params: dict, x: torch.Tensor, torso_dtype=torch.float32, head_dtype=torch.float32):
    """`(N, 980)` features -> `(logits (N, A), value (N,))`. The dtypes
    round the layers' inputs, weights, products and outputs (the model's
    bf16 torso, or a control's lower precisions); float32 rounds nothing."""
    p = params
    h = x
    for layer in ("torso_0", "torso_1"):
        w, b = _q(p[layer]["kernel"], torso_dtype), _q(p[layer]["bias"], torso_dtype)
        h = _q(torch.relu(_q(_q(h, torso_dtype) @ w, torso_dtype) + b), torso_dtype)
    h = _q(h, head_dtype)
    logits = h @ _q(p["actor"]["kernel"], head_dtype) + _q(p["actor"]["bias"], head_dtype)
    value = h @ _q(p["critic"]["kernel"], head_dtype) + _q(p["critic"]["bias"], head_dtype)
    return logits, value[:, 0]


def seeds(key: torch.Tensor, steps: int, b: int) -> torch.Tensor:
    """The `(T, B)` uint32 sampling seeds of a step's key: word `t·B + l`
    of the key's Threefry stream (`jax.random.bits(key, (T, B))`)."""
    i = torch.arange(steps * b, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    return (x0 ^ x1).reshape(steps, b)


def uniform(seed: torch.Tensor) -> torch.Tensor:
    """The 31-bit uniform of each seed, as float32 in `[0, 1]`."""
    return (threefry2x32(seed & MASK32, SALT, 0, 0)[0] & 0x7FFFFFFF).to(torch.float32) * 2.0**-31


def cdf_gap(logits: torch.Tensor, seed: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """How far each seed's uniform lies outside the interval of the
    cumulative distribution that the policy gives `action`, in probability
    (0 where the draw of `action` is the policy's own); `(N,)` float32. An
    action outside the actor's has the interval `[1, 1]`."""
    u = uniform(seed)
    cum = torch.cumsum(torch.softmax(logits, dim=1), dim=1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum, torch.ones_like(cum[:, :1])], dim=1)
    a = action.long().clamp(max=logits.shape[1])[:, None]
    lo = cum.gather(1, a)[:, 0]
    hi = torch.where(a[:, 0] < logits.shape[1], cum.gather(1, a + 1)[:, 0], torch.ones_like(lo))
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def sample(logits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF draw of each row of `(N, A)` logits from one 31-bit
    uniform of its seed: the first action whose cumulative weight exceeds
    `u · total`, counted as `A` less the actions whose weight does. `(N,)`
    int64. Where the uniform rounds to 1.0 in float32 (31-bit values within
    64 of 2^31) none does and the draw is `A`, outside the actor's actions,
    as the ported draw gives it; the world takes it as a step that does
    nothing."""
    u = uniform(seed)
    cum = torch.cumsum(torch.exp(logits - logits.max(dim=1, keepdim=True).values), dim=1)
    return logits.shape[1] - (cum > (u * cum[:, -1])[:, None]).sum(dim=1)


def returns(reward: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Discounted returns `(T, B)`, cut at each episode's end."""
    out = torch.empty_like(reward)
    carry = torch.zeros_like(reward[0])
    for t in range(reward.shape[0] - 1, -1, -1):
        carry = reward[t] + GAMMA * (1.0 - done[t].float()) * carry
        out[t] = carry
    return out


def loss_and_grads(params: dict, obs, actions, ret, adv, view: int, chunk: int, torso_dtype=torch.float32,
                   head_dtype=torch.float32):
    """The actor-critic loss over a `(T, V², B)` trajectory, each term
    summed over all `T·B` samples and divided by their count, and its
    gradient by autograd, `chunk` steps at a time: `(loss, grads)`. A
    sample whose action lies outside the actor's (`sample` gives `A` where
    the uniform rounds to 1.0) has no probability, so no policy-gradient
    term."""
    steps, _, b = obs.shape
    leaves = {n: {k: params[n][k].detach().clone().requires_grad_(True) for k in params[n]} for n in params}
    flat = [leaves[n][k] for n, k in LEAVES]
    acc = [torch.zeros_like(x) for x in flat]
    total = torch.zeros((), dtype=torch.float64, device=obs.device)
    denom = float(steps * b)
    for t0 in range(0, steps, chunk):
        sl = slice(t0, min(steps, t0 + chunk))
        n = (sl.stop - sl.start) * b
        o = obs[sl].permute(1, 0, 2).reshape(obs.shape[1], n)
        logits, value = forward(leaves, features(o, view), torso_dtype, head_dtype)
        logp_all = torch.log_softmax(logits, dim=1)
        a = actions[sl].reshape(n, 1).long()
        valid = (a[:, 0] < logits.shape[1]).float()
        logp = logp_all.gather(1, a.clamp(max=logits.shape[1] - 1))[:, 0] * valid
        entropy = -(logp_all.exp() * logp_all).sum(dim=1)
        loss = (-(logp * adv[sl].reshape(n)).sum() + VALUE_COEF * ((value - ret[sl].reshape(n)) ** 2).sum()
                - ENTROPY_COEF * entropy.sum()) / denom
        acc = [a + g for a, g in zip(acc, torch.autograd.grad(loss, flat))]
        total += loss.detach().double()
    grads = {n: {} for n in params}
    for (n, k), g in zip(LEAVES, acc):
        grads[n][k] = g
    return float(total), grads


class Adam:
    """Global-norm clipping to 0.5 (no epsilon), then Adam with bias
    correction, on a flax-layout tree."""

    def __init__(self, params: dict, state=None):
        """Fresh, or from `state` `(mu tree, nu tree, count)`."""
        if state is None:
            zeros = {n: {k: torch.zeros_like(v) for k, v in params[n].items()} for n in params}
            state = (zeros, zeros, 0)
        mu, nu, self.count = state
        self.mu = {n: dict(mu[n]) for n in mu}
        self.nu = {n: dict(nu[n]) for n in nu}

    def step(self, params: dict, grads: dict):
        """`(new params, the clipped gradient)`."""
        norm = math.sqrt(sum(float((grads[n][k].double() ** 2).sum()) for n, k in LEAVES))
        scale = 1.0 if norm < MAX_GRAD_NORM else MAX_GRAD_NORM / norm
        self.count += 1
        out, clipped = {n: {} for n in params}, {n: {} for n in params}
        for n, k in LEAVES:
            g = grads[n][k] * scale
            clipped[n][k] = g
            self.mu[n][k] = (1 - B1) * g + B1 * self.mu[n][k]
            self.nu[n][k] = (1 - B2) * g * g + B2 * self.nu[n][k]
            m_hat = self.mu[n][k] / (1 - B1**self.count)
            v_hat = self.nu[n][k] / (1 - B2**self.count)
            out[n][k] = params[n][k] - LR * m_hat / (torch.sqrt(v_hat) + EPS)
        return out, clipped
