"""Threefry-2x32 and the `jax.random` key recipes the port consumes
(counterpart of `minigrid_tpu/core/prng.py`).

Keys and words are int64 tensors holding uint32 values in `[0, 2**32)`.
Every add is masked back to 32 bits and the rotation's right shift runs
on the non-negative int64 value, so it is the logical shift that the
reference's `lax.shift_right_logical` is (torch's `>>` on int32 would be
arithmetic).

`split` is bit-identical to `jax.random.split` with
`jax_threefry_partitionable=True` (the default of the JAX package's jax):
child `c` of key `(k0, k1)` is both output words of
`threefry2x32(k0, k1, 0, c)`.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 block cipher, 20 rounds: (key, counter) -> 2 words.

    Arguments are int64 tensors (or ints) of uint32 values, broadcast
    together; the results are int64 tensors of uint32 values."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device)
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=k0.device)
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=k0.device)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in (_ROT_A, _ROT_B)[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a `(2,)` int64 tensor: (high, low)
    32-bit words of a non-negative seed."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor(
        [(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device
    )


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split` over a `(..., 2)` key tensor -> `(..., n, 2)`."""
    k0 = keys[..., 0:1]
    k1 = keys[..., 1:2]
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    return torch.stack([y0, y1], dim=-1)
