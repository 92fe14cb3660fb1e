"""Write MultiRoom-N6's plan and packed layout from the JAX package, for
`tests/port/test_torch_multiroom.py`, which holds the port against this
file (the JAX package's N6 generator takes minutes to compile on a CPU;
the test marked `slow` there recomputes the file and compares).

    JAX_PLATFORMS=cpu python tests/port/make_multiroom_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ENV_ID = "MiniGrid-MultiRoom-N6-v0"
B = 64
SEED = 6
PATH = Path(__file__).resolve().parent / "data" / "multiroom_n6_b64.npz"
STATE_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux")
FIELDS = ("k_reset", "tops", "sizes", "entry", "count", "door_colors", "k_agent", "agent_dir", "k_goal",
          "words", "regs")


def keys() -> np.ndarray:
    """The `(B, 2)` uint32 keys both packages generate from."""
    return np.random.default_rng(SEED).integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)


def jax_plan_and_layout(env_id: str, k: np.ndarray, with_states: bool = False) -> dict:
    """The JAX package's `vmap(_plan)` and `generate_packed` (and, with
    `with_states`, `vmap(generate)`) on `k`, from one `jax.jit`, as numpy
    arrays named as in `FIELDS` (states as `state_<leaf>`)."""
    import jax

    import minigrid_tpu
    from minigrid_tpu.envs import multiroom

    cfg = minigrid_tpu.make(env_id).config

    def run(keys):
        plan = jax.vmap(lambda key: multiroom._plan(key, cfg))(keys)
        out = (plan, multiroom.generate_packed(keys, cfg))
        return out + (jax.vmap(lambda key: multiroom.generate(key, cfg))(keys),) if with_states else out

    res = jax.jit(run)(k)
    plan, (words, regs) = res[0], res[1]
    out = {
        "k_reset": plan.k_reset, "tops": plan.chain.tops, "sizes": plan.chain.sizes, "entry": plan.chain.entry,
        "count": plan.chain.count, "door_colors": plan.door_colors, "k_agent": plan.k_agent,
        "agent_dir": plan.agent_dir, "k_goal": plan.k_goal, "words": words, "regs": regs,
    }
    if with_states:
        out.update({f"state_{name}": getattr(res[2], name) for name in STATE_FIELDS})
    return {name: np.asarray(v) for name, v in out.items()}


def main() -> int:
    ref = jax_plan_and_layout(ENV_ID, keys())
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, keys=keys(), **{name: ref[name] for name in FIELDS})
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
