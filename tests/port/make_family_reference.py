"""Write the JAX package's generator outputs that
`tests/port/test_torch_doorkey.py`, `tests/port/test_torch_hooks.py`,
`tests/port/test_torch_dynamicobstacles.py`,
`tests/port/test_torch_memory_unlock.py`,
`tests/port/test_torch_rooms_crossings.py`,
`tests/port/test_torch_obstructedmaze.py` and
`tests/port/test_torch_engine.py` hold the port's generators
against (`data/family_generators_b32.npz`), and recompute them live for
those files' `slow` tests.

For each of the 55 ids of Empty-Random, DoorKey, Fetch, GoToDoor,
GoToObject, PutNear, RedBlueDoors, DynamicObstacles, Memory, Unlock,
UnlockPickup, BlockedUnlockPickup, LavaGap, FourRooms, Lava and Simple
Crossing, LockedRoom, Playground and ObstructedMaze: `jax.vmap(generate)`
on the 32 keys `split(key(21), 32)`, every state field stored as
`<env id>/<field>`. Each generator takes one to six seconds to compile on
a CPU (ObstructedMaze's are the deepest); the tier-1
run compiles none of them, which keeps its worker processes clear of
jaxlib's crash after many compiles in one process (pyproject.toml).

    JAX_PLATFORMS=cpu python tests/port/make_family_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root: both packages

PATH = Path(__file__).resolve().parent / "data" / "family_generators_b32.npz"
B = 32
SEED = 21
STATE_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux")
DOORKEY_IDS = [f"MiniGrid-Empty-Random-{s}x{s}-v0" for s in (5, 6)] + [
    f"MiniGrid-DoorKey-{s}x{s}-v0" for s in (5, 6, 8, 16)]
HOOKED_IDS = (
    [f"MiniGrid-Fetch-{n}-v0" for n in ("5x5-N2", "6x6-N2", "8x8-N3")]
    + [f"MiniGrid-GoToDoor-{s}x{s}-v0" for s in (5, 6, 8)]
    + [f"MiniGrid-GoToObject-{s}x{s}-N2-v0" for s in (6, 8)]
    + [f"MiniGrid-PutNear-{n}-v0" for n in ("6x6-N2", "8x8-N3")]
    + [f"MiniGrid-RedBlueDoors-{s}x{s}-v0" for s in (6, 8)]
)
DYNOBST_IDS = [f"MiniGrid-Dynamic-Obstacles-{n}-v0" for n in ("5x5", "Random-5x5", "6x6", "Random-6x6", "8x8", "16x16")]
MEMORY_UNLOCK_IDS = [f"MiniGrid-Memory{n}-v0" for n in ("S17Random", "S13Random", "S13", "S11", "S9", "S7")] + [
    "MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0", "MiniGrid-BlockedUnlockPickup-v0"]
ROOMS_CROSSINGS_IDS = (
    [f"MiniGrid-LavaGapS{s}-v0" for s in (5, 6, 7)]
    + ["MiniGrid-FourRooms-v0"]
    + [f"MiniGrid-{o}CrossingS{n}-v0" for o in ("Lava", "Simple") for n in ("9N1", "9N2", "9N3", "11N5")]
    + ["MiniGrid-LockedRoom-v0", "MiniGrid-Playground-v0"]
)
OBSTRUCTED_IDS = [f"MiniGrid-ObstructedMaze-{n}-v0" for n in ("1Dl", "1Dlh", "1Dlhb", "2Dlh", "2Dlhb", "1Q", "2Q", "Full")]
ALL_IDS = DOORKEY_IDS + HOOKED_IDS + DYNOBST_IDS + MEMORY_UNLOCK_IDS + ROOMS_CROSSINGS_IDS + OBSTRUCTED_IDS


def keys():
    """The `(B, 2)` keys, as the port's int64 tensor (CPU)."""
    from minigrid_tpu_torch.core.prng import key, split

    return split(key(SEED, device="cpu"), B)


def jax_states(env_id: str) -> dict:
    """`jax.vmap(generate)` of the JAX package on `keys()`, as numpy."""
    import jax

    import minigrid_tpu

    env = minigrid_tpu.make(env_id)
    states = jax.jit(jax.vmap(lambda k: env.generate(k, env.config)))(keys().numpy().astype(np.uint32))
    return {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS}


def states(env_id: str, path: Path = PATH) -> dict:
    """`env_id`'s state fields from the file."""
    with np.load(path) as f:
        return {k.split("/", 1)[1]: f[k] for k in f.files if k.split("/", 1)[0] == env_id}


def assert_port_matches(env_id: str, want: dict) -> None:
    """The port's generator on `keys()` against `want` (`states` or
    `jax_states`), byte for byte, dtypes included."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    env = make(env_id)
    got = state_to_numpy(env.generate(keys(), env.config))
    for name in STATE_FIELDS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{env_id} {name}")


def main() -> int:
    arrays = {f"{e}/{k}": v for e in ALL_IDS for k, v in jax_states(e).items()}
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
