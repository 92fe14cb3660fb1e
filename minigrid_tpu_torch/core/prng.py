"""Threefry-2x32 and the `jax.random` key recipes the port consumes
(counterpart of `minigrid_tpu/core/prng.py`).

Keys and words are int64 tensors holding uint32 values in `[0, 2**32)`.
Every add is masked back to 32 bits and the rotation's right shift runs
on the non-negative int64 value, so it is the logical shift that the
reference's `lax.shift_right_logical` is (torch's `>>` on int32 would be
arithmetic).

`split` and `random_bits` are bit-identical to `jax.random.split` and
`jax.random.bits(..., uint32)` with `jax_threefry_partitionable=True`
(the default of the JAX package's jax): child `c` of key `(k0, k1)` is
both output words of `threefry2x32(k0, k1, 0, c)`, and word `i` of a bits
draw (row-major flat index) is `x0 ^ x1` of `threefry2x32(k0, k1,
hi32(i), lo32(i))`.

`bits`, `randint`, `categorical`, `permutation` and `permute` are the
draws the generators make (`jax.random.bits(key, (), uint32)`,
`jax.random.randint(key, (), lo, hi)`, `jax.random.categorical(key,
logits)`, `jax.random.permutation(key, n)` and `jax.random.permutation(key,
x)` of an array), vectorised over a batch of keys. `fold_in` is
`jax.random.fold_in`, and `randint_stream` the random policy's `(T, B)`
draws from one key.

`key` makes its tensor on the card unless the caller names a device, as
every entry point of the port does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_BITS_CHUNK = 1 << 24  # counters per Threefry pass of `random_bits`
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


def default_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when it is None. Raises on a
    machine without a card: the port's entry points run on the card
    unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a `(2,)` int64 tensor: (high, low)
    32-bit words of a non-negative seed, on `device` (default: the card)."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    device = default_device(device)
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


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` over a `(..., 2)` key tensor, for
    `0 <= data < 2**32`: Threefry of the key over the counter words
    `threefry_seed(data) = (0, data)` (`jax._src.prng._threefry_fold_in`),
    both output words. With `jax_threefry_partitionable` that is child
    `data` of `split(key, n)` for any `n > data`."""
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must be a uint32, got {data}")
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def hash_u31(k0, k1, counter) -> torch.Tensor:
    """The JAX package's `core.prng.hash_u31`: one non-negative int32 (31
    uniform bits) per (key, counter). Arguments are int32 (or int64)
    tensors or ints, read as their low 32 bits."""
    k0 = torch.as_tensor(k0).to(torch.int64) & MASK32
    k1 = torch.as_tensor(k1, device=k0.device).to(torch.int64) & MASK32
    counter = torch.as_tensor(counter, device=k0.device).to(torch.int64) & MASK32
    h0, _ = threefry2x32(k0, k1, counter, torch.zeros_like(counter))
    return (h0 & 0x7FFFFFFF).to(torch.int32)


def random_bits(key: torch.Tensor, shape, dtype=torch.int64, lane0: int = 0, total=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` on `key.device`: as int64
    uint32 values, or with `dtype=torch.int32` as their int32 bit patterns
    (`lax.bitcast_convert_type`). With `lane0` (and `total`, the whole
    batch's width, default `lane0 + shape[-1]`), columns `lane0` to `lane0 +
    shape[-1]` of the draw over `shape[:-1] + (total,)`, computed without
    the rest (word `i` depends on `i` alone): a shard's lanes of a draw
    over the whole batch. Threefry runs over at most `_BITS_CHUNK` counters
    at a time, so its int64 temporaries stay a few hundred MB whatever the
    shape."""
    shape = tuple(int(n) for n in shape)
    n = shape[-1] if shape else 1
    width = lane0 + n if total is None else int(total)
    if lane0 < 0 or lane0 + n > width:
        raise ValueError(f"lanes {lane0}..{lane0 + n} outside a last axis of {width}")
    rows = math.prod(shape[:-1])
    out = torch.empty((rows, n), dtype=dtype, device=key.device)
    k0, k1 = key[0], key[1]
    cols = torch.arange(lane0, lane0 + n, dtype=torch.int64, device=key.device)
    step = max(1, _BITS_CHUNK // max(n, 1))
    for start in range(0, rows, step):
        r = torch.arange(start, min(rows, start + step), dtype=torch.int64, device=key.device)
        i = r[:, None] * width + cols
        x0, x1 = threefry2x32(k0, k1, i >> 32, i & MASK32)
        bits = x0 ^ x1
        out[start : start + r.numel()] = _as_int32(bits) if dtype == torch.int32 else bits
    return out.reshape(shape)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 with the same bit patterns (the
    reference's `bitcast_convert_type(uint32 -> int32)`)."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def bits(keys: torch.Tensor) -> torch.Tensor:
    """`jax.random.bits(key, (), uint32)` per key of a `(..., 2)` key
    tensor: `x0 ^ x1` of `threefry2x32(k0, k1, 0, 0)`, as int64 uint32
    values of shape `(...)`."""
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return x0 ^ x1


def randint(keys: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jax.random.randint(key, (), lo, hi)` (int32) per key of a `(..., 2)`
    key tensor; `lo` and `hi` are ints or int tensors that broadcast
    against `keys[..., 0]`.

    The double draw of `jax._src.random._randint`: `k1, k2 = split(key)`,
    `higher = bits(k1)`, `lower = bits(k2)`, then `((higher mod n) ·
    ((2^16 mod n)^2 mod n) + lower mod n) mod n` in uint32 arithmetic for
    the span `n = hi - lo` (1 where `hi <= lo`)."""
    higher, lower = randint_bits(keys)
    return randint_from_bits(higher, lower, lo, hi)


def randint_bits(keys: torch.Tensor):
    """The `(higher, lower)` uint32 words `randint` reduces, per key of a
    `(..., 2)` key tensor: `bits` of the two children of `split(key)`."""
    return bits(split(keys, 2)).unbind(-1)  # one Threefry pass for both


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, lo, hi) -> torch.Tensor:
    """`randint`'s reduction of its two words to `[lo, hi)` (int32); a key
    whose words are reduced twice, over two spans, is two `randint` draws
    from the same key."""
    dev = higher.device
    lo = torch.as_tensor(lo, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=dev)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    mult = (65536 % span) ** 2 % span
    off = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    return (lo + off % span).to(torch.int32)


def _randint_rows(halves: torch.Tensor, batch: int, lo, hi, lane0: int = 0) -> torch.Tensor:
    """`jax.random.randint(k, (batch,), lo, hi)` per row, from `halves`
    `(..., 2, 2)`: the two children of `split(k)` of each row's key. A
    shaped `randint` draws `bits(k, (batch,))` of both children (counters
    `(0, i)` for lane `i`) and reduces them as `randint_from_bits` does;
    with `lane0`, lanes `lane0` to `lane0 + batch` of a larger draw."""
    lanes = torch.arange(lane0, lane0 + batch, dtype=torch.int64, device=halves.device)
    x0, x1 = threefry2x32(halves[..., 0:1], halves[..., 1:2], lanes >> 32, lanes & MASK32)  # (..., 2, B)
    words = x0 ^ x1
    return randint_from_bits(words[..., 0, :], words[..., 1, :], lo, hi)


def randint_lanes(key: torch.Tensor, batch: int, lo: int, hi: int, lane0: int = 0) -> torch.Tensor:
    """`jax.random.randint(key, (batch,), lo, hi)` for one `(2,)` key:
    `(batch,)` int32, one row of `randint_stream`; with `lane0`, lanes
    `lane0` to `lane0 + batch` of a draw over a larger batch (a shard's)."""
    return _randint_rows(split(key, 2), batch, lo, hi, lane0)


def randint_stream(key: torch.Tensor, num_steps: int, batch: int, lo: int, hi: int) -> torch.Tensor:
    """The JAX package's random policy from one `(2,)` key: `keys =
    split(key, num_steps)`, then `jax.random.randint(keys[t], (batch,), lo,
    hi)` for each step (`_randint_rows`), as a `(num_steps, batch)` int32
    tensor. Threefry runs over at most `_BITS_CHUNK` counters at a time."""
    halves = split(split(key, num_steps), 2)  # (T, 2 [higher, lower], 2)
    out = torch.empty((num_steps, batch), dtype=torch.int32, device=key.device)
    rows = max(1, _BITS_CHUNK // max(2 * batch, 1))
    for start in range(0, num_steps, rows):
        out[start : start + rows] = _randint_rows(halves[start : start + rows], batch, lo, hi)
    return out


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` per row, for `(B, 2)` keys and
    `(B, N)` logits whose entries are 0 or -inf (a uniform draw over a
    mask, the only kind the generators make). Returns `(B,)` int64.

    jax 0.9 takes `argmax(logits + gumbel)` with `gumbel = -log(-log(u))`
    in f32, `u = max(tiny, f·(1 - tiny) + tiny)` and `f = (bits >> 9) ·
    2^-23` from `bits(key, (N,))`. `u` rises strictly with `m = bits >>
    9`, and so does jax's f32 gumbel over all 2^23 values of `m`
    (asserted in tests/port/test_torch_prng.py), so the draw is the first
    index of the largest `m` among the finite logits: an integer argmax,
    free of any float `log` that could round apart from XLA's."""
    b, n = logits.shape
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    idx = torch.arange(n, dtype=torch.int64, device=logits.device)
    rows = max(1, _BITS_CHUNK // max(n, 1))  # lanes per Threefry pass
    for start in range(0, b, rows):
        k = keys[start : start + rows]
        x0, x1 = threefry2x32(k[:, 0:1], k[:, 1:2], 0, idx)  # (rows, N)
        m = (x0 ^ x1) >> 9
        score = torch.where(torch.isfinite(logits[start : start + rows]), m * n + (n - 1 - idx), -1)
        out[start : start + rows] = score.argmax(dim=1)
    return out


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """jax 0.9's f32 gumbel (`_gumbel`, mode "low") of uint32 `bits` (int64
    values): `-log(-log(u))` with `u = max(tiny, f·(1 - tiny) + tiny)` and
    `f = (bits >> 9) · 2^-23`, each operation in f32 as jax takes it. The
    two `log`s are torch's: on an x86 CPU about a quarter of the 2^23
    values of `bits >> 9` give a gumbel that rounds apart from XLA's, by at
    most 2^-22 of max(1, |g|) (counted in
    tests/port/test_torch_parallel_train.py)."""
    m = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = m.view(torch.float32) - 1.0
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=torch.float32, device=bits.device)
    u = torch.maximum(tiny, floats * (torch.tensor(1.0, dtype=torch.float32, device=bits.device) - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical_logits(key: torch.Tensor, logits: torch.Tensor, lane0: int = 0) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` for one `(2,)` key and `(B, N)`
    f32 logits: `argmax(logits + gumbel(bits(key, (B, N))))` along the
    last axis, the first index of a tie, as `(B,)` int64. With `lane0`,
    the rows are lanes `lane0` to `lane0 + B` of a draw over a larger batch
    (a shard's lanes: word `(b, a)` is counter `b·N + a`), computed
    without the rest. Unlike `categorical`'s integer argmax over 0/-inf
    masks, this adds float gumbels, so an action can differ from XLA's
    where a `log` rounds apart and the logits nearly tie."""
    b, n = logits.shape
    bits = random_bits(key.to(logits.device), (1, b * n), lane0=lane0 * n).reshape(b, n)
    return torch.argmax(logits.to(torch.float32) + gumbel(bits), dim=1)


def sort_key_val(sort_keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`lax.sort_key_val(sort_keys, values)[1]` along the last dimension:
    `values` reordered by ascending `sort_keys` (int64 uint32 values), ties
    kept in their order (a stable sort, as XLA's)."""
    order = torch.sort(sort_keys, dim=-1, stable=True).indices
    return torch.gather(values, -1, order)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` per key of a `(B, 2)` key tensor:
    `(B, n)` int64.

    jax 0.9's `_shuffle`: `ceil(3·ln n / ln(2^32 - 1))` rounds (one for
    any n a generator uses), each `key, sub = split(key)`, then 32-bit
    `bits(sub, (n,))` as sort keys of a stable sort of the values."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = idx.expand(keys.shape[0], n)
    for _ in range(rounds):
        pair = split(keys, 2)
        keys, sub = pair[:, 0], pair[:, 1]
        x0, x1 = threefry2x32(sub[:, 0:1], sub[:, 1:2], 0, idx)  # bits(sub, (n,)): counters (0, i)
        x = sort_key_val(x0 ^ x1, x)
    return x


def permute(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`jax.random.permutation(key, x)` of a 1-D array per key: `(B, 2)`
    keys and `(B, n)` values, one array per lane. jax shuffles `x` itself
    with the sort keys and round count (from `x`'s length) that it uses for
    `arange(n)`, and the sort is stable, so the result is `values` gathered
    at `permutation(keys, n)`."""
    return torch.gather(values, 1, permutation(keys, values.shape[1]))
