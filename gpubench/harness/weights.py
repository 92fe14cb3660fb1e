"""The actor-critic's initial weights, made on the card from the seed: a
flax-layout tree of float32 tensors, kernels drawn as flax's default
(truncated LeCun normal: a normal cut at two standard deviations, scaled
to variance 1 / fan_in), biases zero. The benchmark hands the same tree
to the program and to the reference."""

from __future__ import annotations

import math

import torch

from gpubench.harness.traffic import stream_seed

SIZES = {"torso_0": (980, 256), "torso_1": (256, 256), "actor": (256, 7), "critic": (256, 1)}


def flax_params(seed: int, device, num_actions: int = 7) -> dict:
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    out = {}
    for name, (n_in, n_out) in SIZES.items():
        n_out = num_actions if name == "actor" else n_out
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978
        kernel = torch.empty((n_in, n_out), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=g)
        out[name] = {"kernel": kernel, "bias": torch.zeros(n_out, dtype=torch.float32, device=device)}
    return out
