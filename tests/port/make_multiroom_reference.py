"""Write the JAX package's MultiRoom outputs that
`tests/port/test_torch_multiroom.py` holds the port against, and recompute
them live for that file's `slow` tests (the JAX package's MultiRoom
generator takes 25-70 s to compile on a CPU, N6's minutes):

  * `data/multiroom_n6_b64.npz`: N6's plan and packed layout on `keys()`;
  * `data/multiroom_plan_layout_b64.npz`: N2-S4's plan, packed layout and
    `vmap(generate)` states, and N4-S5's plan and layout, on
    `plan_keys()`;
  * `data/multiroom_n2s4_regen.npz`: N2-S4 chunked regen from the port's
    `packed_init` carry (`port_carry`), two calls each: the random policy
    against `build_packed_xla_rollout(mode="regen", regen_chunk=8)`, with
    `max_steps` as registered and cut to 5, and the actor in the loop
    under dyadic weights against `build_policy_eval_rollout(backend="xla",
    regen_chunk=8)` with `max_steps` cut to 5. Each case stores its input
    carry beside the outputs.

    JAX_PLATFORMS=cpu python tests/port/make_multiroom_reference.py [n6] [plan] [regen]

(with no argument, all three files).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

ENV_ID = "MiniGrid-MultiRoom-N6-v0"
N2, N4 = "MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-MultiRoom-N4-S5-v0"
B = 64
SEED = 6
DATA = Path(__file__).resolve().parent / "data"
PATH = DATA / "multiroom_n6_b64.npz"
PLAN_PATH = DATA / "multiroom_plan_layout_b64.npz"
REGEN_PATH = DATA / "multiroom_n2s4_regen.npz"
PLAN_IDS = {"n2s4": N2, "n4s5": N4}
PLAN_SEED = 4
STATE_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux")
FIELDS = ("k_reset", "tops", "sizes", "entry", "count", "door_colors", "k_agent", "agent_dir", "k_goal",
          "words", "regs")
CARRY_FIELDS = ("words", "regs", "tmpl_words", "tmpl_regs", "rng")
METRIC_FIELDS = ("episodes", "total_reward", "total_steps", "obs_checksum", "reset_overlaps")

# Chunked regen at N2-S4: name -> (path, B, T, max_steps, carry seed,
# source seed). The random policy's actions are `actions(B, T)`; the
# policy's weights `testing.dyadic_flax_params(POLICY_PARAMS_SEED)`.
REGEN_CHUNK = 8
REGEN_CASES = {
    "random_registered": ("random", 128, 48, None, 5, 0),
    "random_max5": ("random", 128, 48, 5, 5, 0),
    "policy_max5": ("policy", 64, 16, 5, 7, 11),
}
POLICY_PARAMS_SEED = 3


def keys() -> np.ndarray:
    """The `(B, 2)` uint32 keys both packages generate N6 from."""
    return np.random.default_rng(SEED).integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)


def plan_keys(b: int = B, seed: int = PLAN_SEED) -> np.ndarray:
    """The `(b, 2)` uint32 keys of N2-S4's and N4-S5's plans and layouts."""
    return np.random.default_rng(seed).integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)


def actions(b: int, t: int, seed: int = 0) -> np.ndarray:
    """The random policy's `(T, B)` actions, the same for both calls."""
    return np.random.default_rng(seed).integers(0, 7, (t, b)).astype(np.int32)


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


def jax_plan_layouts() -> dict:
    """`PLAN_PATH`'s arrays: `<tag>/<field>` for N2-S4 (with states) and N4-S5."""
    out = {}
    for tag, env_id in PLAN_IDS.items():
        for name, v in jax_plan_and_layout(env_id, plan_keys(), with_states=env_id == N2).items():
            out[f"{tag}/{name}"] = v
    return out


def with_max_steps(env, max_steps):
    """`env` with `max_steps` replaced (None leaves it as registered);
    either package's `Env`."""
    if max_steps is None:
        return env
    return dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))


def port_carry(env_id: str, b: int, seed: int, max_steps=None, mode: str = "regen", states=None):
    """The port's `packed_init` carry of `reset_batch(key(seed), b)` (or of
    `states`, a numpy state dictionary) on the CPU."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as tfr
    from minigrid_tpu_torch.utils.convert import state_from_numpy

    env = with_max_steps(make(env_id), max_steps)
    if states is None:
        states, _ = env.reset_batch(key(seed, device="cpu"), b)
    else:
        states = state_from_numpy(states, device="cpu")
    return tfr.packed_init(env, states, mode)


def carry_arrays(carry) -> dict:
    """A carry of either package as `{field: numpy array}`."""
    import torch

    from minigrid_tpu_torch.utils.convert import carry_to_numpy

    if isinstance(carry.words, torch.Tensor):
        return carry_to_numpy(carry)
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def jax_carry(arrays: dict):
    """A numpy carry dictionary as the JAX package's `PackedCarry`."""
    import jax.numpy as jnp
    from minigrid_tpu.ops import fused_rollout as jfr

    return jfr.PackedCarry(**{k: jnp.asarray(arrays[k]) for k in CARRY_FIELDS})


def call_arrays(prefix: str, carry, metrics, traj=None) -> dict:
    """One call's results as flat `<prefix>/...` arrays: the carry, the
    metrics and, for a collecting rollout, the six trajectory arrays."""
    out = {f"{prefix}/carry/{k}": v for k, v in carry_arrays(carry).items()}
    out.update({f"{prefix}/metrics/{k}": np.asarray(getattr(metrics, k)) for k in METRIC_FIELDS})
    if traj is not None:
        out.update({f"{prefix}/traj/{i}": np.asarray(x) for i, x in enumerate(traj)})
    return out


def jax_regen_case(name: str) -> dict:
    """`REGEN_PATH`'s arrays of one case: `<name>/in/<field>` (the port's
    carry the JAX package starts from) and `<name>/call<i>/...` for its two
    calls."""
    import jax

    import minigrid_tpu
    from minigrid_tpu.ops import fused_rollout as jfr
    from minigrid_tpu.ops import policy_rollout as jpr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    path, b, t, max_steps, carry_seed, source_seed = REGEN_CASES[name]
    env = with_max_steps(minigrid_tpu.make(N2), max_steps)
    carry0 = carry_arrays(port_carry(N2, b, carry_seed, max_steps))
    if path == "random":
        step = jfr.build_packed_xla_rollout(env, t, mode="regen", regen_chunk=REGEN_CHUNK, as_carry=True,
                                            actions_override=actions(b, t))
    else:
        step = jpr.build_policy_eval_rollout(env, dyadic_flax_params(POLICY_PARAMS_SEED), t, mode="regen",
                                             backend="xla", regen_chunk=REGEN_CHUNK, as_carry=True)
    step = jax.jit(step)
    out = {f"{name}/in/{k}": v for k, v in carry0.items()}
    carry = jax_carry(carry0)
    for i in range(2):
        carry, metrics = step(jax.random.PRNGKey(source_seed), carry)
        out.update(call_arrays(f"{name}/call{i}", carry, metrics))
    return out


def load(path: Path) -> dict:
    with np.load(path) as f:
        return dict(f)


def assert_same_arrays(got: dict, want: dict, rtol_names=("total_reward",)) -> None:
    """Every array of `want` in `got` with its dtype and shape, equal (the
    names ending in one of `rtol_names`, float sums, to rtol 1e-6)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, g.shape, w.dtype, w.shape)
        if name.endswith(rtol_names):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def main(which=("n6", "plan", "regen")) -> int:
    DATA.mkdir(parents=True, exist_ok=True)
    if "n6" in which:
        ref = jax_plan_and_layout(ENV_ID, keys())
        np.savez_compressed(PATH, keys=keys(), **{name: ref[name] for name in FIELDS})
        print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    if "plan" in which:
        np.savez_compressed(PLAN_PATH, **jax_plan_layouts())
        print(f"wrote {PLAN_PATH} ({PLAN_PATH.stat().st_size} bytes)")
    if "regen" in which:
        regen = {}
        for name in REGEN_CASES:
            regen.update(jax_regen_case(name))
        np.savez_compressed(REGEN_PATH, **regen)
        print(f"wrote {REGEN_PATH} ({REGEN_PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root: both packages
    sys.exit(main(tuple(sys.argv[1:]) or ("n6", "plan", "regen")))
