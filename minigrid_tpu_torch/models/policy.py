"""Actor-critic network over symbolic MiniGrid observations (counterpart of
`minigrid_tpu/models/policy.py`).

The same network as the JAX package's flax `ActorCritic`: one-hot
features of the `(V, V, 3)` observation, a 256 -> 256 MLP torso computed
in bfloat16, and f32 actor and critic heads. Parameters are f32, stored in
`nn.Linear` submodules named as the flax params are (`torso_0`,
`torso_1`, `actor`, `critic`), so a flax params tree loads into it
(`load_flax_params`, `ActorCritic.from_flax`).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.prng import default_device

# One-hot widths per observation channel: object type, color, door state.
CHANNEL_WIDTHS = (C.NUM_OBJECTS, C.NUM_COLORS, C.NUM_STATES)


def encode_obs(obs_image: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., V, V, 3) integer -> (..., V*V*20) flat one-hot features. A
    value outside its channel's width gives an all-zero one-hot, as
    `jax.nn.one_hot` does."""
    img = obs_image.to(torch.int64)
    feats = [
        (img[..., i : i + 1] == torch.arange(w, device=img.device)).to(dtype)
        for i, w in enumerate(CHANNEL_WIDTHS)
    ]
    x = torch.cat(feats, dim=-1)
    return x.reshape(x.shape[:-3] + (-1,))


def _bf16_dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax's `Dense(dtype=bfloat16)`: inputs and kernel cast to bf16, their
    product summed in f32 and rounded to bf16, then the bf16 bias added
    (an f32 add rounded once to bf16, as torch and XLA:CPU add two bf16)."""
    w = layer.weight.to(torch.bfloat16).float()
    y = (x.to(torch.bfloat16).float() @ w.T).to(torch.bfloat16)
    return (y.float() + layer.bias.to(torch.bfloat16).float()).to(torch.bfloat16)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init, `variance_scaling(1, "fan_in",
    "truncated_normal")`: a normal cut at two standard deviations, scaled
    so that the cut distribution has variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class ActorCritic(nn.Module):
    """MLP torso + policy/value heads; compute in bfloat16, params f32.

    The parameters are drawn from `generator` (default: a generator seeded
    with 0 on `device`, itself the card by default) with flax's default
    initialisers: truncated LeCun-normal kernels, zero biases."""

    def __init__(
        self,
        num_actions: int,
        hidden: Sequence[int] = (256, 256),
        view: int = 7,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if generator is not None:
            device = torch.device(generator.device)
        else:
            device = default_device(device)
            generator = torch.Generator(device=device).manual_seed(0)
        sizes = [view * view * sum(CHANNEL_WIDTHS), *hidden]
        for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"torso_{i}", nn.Linear(n_in, n_out, device=device))
        self.actor = nn.Linear(sizes[-1], num_actions, device=device)
        self.critic = nn.Linear(sizes[-1], 1, device=device)
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.view = view
        for layer in self._layers():
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def _layers(self):
        return [getattr(self, f"torso_{i}") for i in range(len(self.hidden))] + [self.actor, self.critic]

    def forward(self, obs_image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., V, V, 3) integer observations -> (logits (..., A) f32,
        value (...) f32)."""
        x = encode_obs(obs_image, torch.bfloat16)
        for i in range(len(self.hidden)):
            x = torch.relu(_bf16_dense(x, getattr(self, f"torso_{i}")))
        x = x.float()
        logits = x @ self.actor.weight.T + self.actor.bias
        value = x @ self.critic.weight.T + self.critic.bias
        return logits, value[..., 0]

    def flax_params(self) -> dict:
        """The parameters as a flax params tree of (detached) tensors:
        kernels `(in, out)`, biases `(out,)`."""
        names = [f"torso_{i}" for i in range(len(self.hidden))] + ["actor", "critic"]
        return {"params": {
            n: {"kernel": layer.weight.detach().T, "bias": layer.bias.detach()}
            for n, layer in zip(names, self._layers())
        }}

    @classmethod
    def from_flax(cls, params: Mapping, device=None) -> "ActorCritic":
        """A module on `device` (default: the card) holding a flax params
        tree of numpy arrays (`{"params": {"torso_0": {"kernel": (980,
        256), "bias": (256,)}, ...}}`)."""
        p = params["params"]
        n_torso = sum(1 for k in p if k.startswith("torso_"))
        hidden = [np.shape(p[f"torso_{i}"]["kernel"])[1] for i in range(n_torso)]
        n_in = np.shape(p["torso_0"]["kernel"])[0]
        view = math.isqrt(n_in // sum(CHANNEL_WIDTHS))
        num_actions = np.shape(p["actor"]["kernel"])[1]
        device = default_device(device)
        model = cls(num_actions, hidden, view, generator=torch.Generator(device=device).manual_seed(0))
        load_flax_params(model, params)
        return model


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, np.float32))


def load_flax_params(model: ActorCritic, params: Mapping) -> ActorCritic:
    """Copy a flax `ActorCritic` params tree (numpy arrays or tensors;
    kernels `(in, out)`) into `model`, in place; returns `model`."""
    p = params["params"]
    names = [f"torso_{i}" for i in range(len(model.hidden))] + ["actor", "critic"]
    with torch.no_grad():
        for name, layer in zip(names, model._layers()):
            kernel, bias = _f32(p[name]["kernel"]), _f32(p[name]["bias"])
            if tuple(kernel.shape) != tuple(layer.weight.T.shape) or tuple(bias.shape) != tuple(layer.bias.shape):
                raise ValueError(
                    f"{name}: kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} do not fit "
                    f"{tuple(layer.weight.T.shape)} / {tuple(layer.bias.shape)}"
                )
            layer.weight.copy_(kernel.T)
            layer.bias.copy_(bias)
    return model
