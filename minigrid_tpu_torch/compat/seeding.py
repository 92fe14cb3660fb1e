"""Old-gym seeding: seed → MT19937 `RandomState` (a copy of
`minigrid_tpu/compat/seeding.py`).

The reference seeds env RNG via `gym.utils.seeding.np_random(seed)`
(minigrid.py:~750), which in the old-gym era (gym ≤0.21) derived an
MT19937 `RandomState` from a SHA-512 hash of the seed string. Reproduced
here (from the documented algorithm) so the compat layout replayer is
bit-exact with reference layouts under equal seeds.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional, Tuple

import numpy as np


def create_seed(a: Optional[int] = None, max_bytes: int = 8) -> int:
    if a is None:
        a = _bigint_from_bytes(_urandom(max_bytes))
    elif isinstance(a, int):
        a = a % 2 ** (8 * max_bytes)
    else:
        raise TypeError(f"invalid seed type: {type(a)}")
    return a


def _urandom(n: int) -> bytes:
    import os

    return os.urandom(n)


def hash_seed(seed: int, max_bytes: int = 8) -> int:
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def _bigint_from_bytes(bts: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(bts) % sizeof_int
    bts += b"\0" * padding
    int_count = len(bts) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bts)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int):
    if bigint < 0:
        raise ValueError("seed must be non-negative")
    if bigint == 0:
        return [0]
    ints = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2**32)
        ints.append(mod)
    return ints


def np_random(seed: Optional[int] = None) -> Tuple[np.random.RandomState, int]:
    """seed → (MT19937 RandomState, seed), old-gym style."""
    seed = create_seed(seed)
    rng = np.random.RandomState()
    rng.seed(_int_list_from_bigint(hash_seed(seed)))
    return rng, seed
