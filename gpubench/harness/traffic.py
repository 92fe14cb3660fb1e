"""The general generator of the traffic: every input of a run drawn from
its `--seed`, the same for the program and for the reference."""

from __future__ import annotations

MASK64 = (1 << 64) - 1


def run_seed(seed: int) -> int:
    """`--seed` (any whole number) as the 64-bit seed of the run's keys."""
    return seed & MASK64


def stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for stream `stream` of a run (a `torch.Generator`
    takes 64 bits)."""
    return (run_seed(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (stream + 1)) & ((1 << 63) - 1)


def uniform_actions(generator_state, steps: int, batch: int, num_actions: int, device):
    """The `(steps, batch)` int32 uniform actions that a generator in
    `generator_state` draws: `torch.randint` on the card, as the random
    policy of the carry surface draws them."""
    import torch

    g = torch.Generator(device=device)
    g.set_state(generator_state)
    return torch.randint(0, num_actions, (steps, batch), dtype=torch.int32, generator=g, device=device)
