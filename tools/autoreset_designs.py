"""Two designs of the per-env engine's auto-reset, timed on a CUDA card at
`chip_smoke.py` phase 19d's and 19e's cells.

    python tools/autoreset_designs.py [--pairs N]

  finished  the port's (`core/autoreset.py::make_autoreset_step`,
            `MixedEnv.autoreset_step`): the lanes whose episode ended are
            found (`nonzero`, which makes the host wait for the card) and
            only they are generated
  every     the JAX package's: every lane is generated at every step and
            `select_state` keeps the fresh state where the episode ended
            (no wait)

Each cell is `core/rollout.py::run_rollout` under the key-drawn random
policy from the same states: 19d's three (B = 32,768, T = 64, step counts
within 2·T of `max_steps`) and 19e's config-5 `MixedEnv` (B = 8,192, T =
64). Both designs run once to warm up, then in the order finished, every,
every, finished, `--pairs` times (default 2). Every call is checked equal
to the first (every state field and the integer metrics). Prints each
call's seconds, each design's median and its env-steps/s, beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def every_lane_step(env, mode):
    """The JAX package's auto-reset on the port's pieces: every lane
    generated at every step, then `select_state`."""
    from minigrid_tpu_torch.core.autoreset import select_state
    from minigrid_tpu_torch.core.step import as_actions
    from minigrid_tpu_torch.envs.base import step_fn

    transition = step_fn(env.transition)

    def step(state, action):
        res = transition(state, as_actions(state, action), env.config)
        keys = res.state.rng if mode == "regen" else state.rng
        fresh = env.generate(keys, env.config)
        fresh = fresh if mode == "regen" else fresh.replace(rng=keys)
        new = select_state(res.terminated | res.truncated, fresh, res.state)
        return new, env.observe(new, env.config), res.reward, res.terminated, res.truncated

    return step


def every_lane_mixed_step(menv):
    """`MixedEnv.autoreset_step` with every lane generated at every step."""
    from minigrid_tpu_torch.core.autoreset import select_state
    from minigrid_tpu_torch.parallel.mixed import FAMILY_SLOT

    def step(state, action):
        res = menv._transition(state, action)
        s = res.state
        new = select_state(res.terminated | res.truncated, menv._generate(s.rng, s.aux[:, FAMILY_SLOT]), s)
        return new, menv.observe(new), res.reward, res.terminated, res.truncated

    return step


def cells(dev):
    """`[(label, b, observe, num_actions, states, {design: auto_step})]`."""
    import torch

    import chip_smoke as cs
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.autoreset import make_autoreset_step
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.parallel import mixed

    out = []
    for env_id, mode in cs.ENGINE_CELLS:
        env = make(env_id)
        states, _ = env.reset_batch(key(0, device=dev), cs.ENGINE_B)
        states = states.replace(step_count=cs._near_the_end(states.step_count, env.config.max_steps,
                                                            2 * cs.ENGINE_T, dev, 19))
        steps = {"finished": make_autoreset_step(env, mode), "every": every_lane_step(env, mode)}
        out.append((f"{env_id} {mode}", cs.ENGINE_B, lambda s, env=env: env.observe(s, env.config),
                    env.num_actions, states, steps))
    menv = mixed.MixedEnv.create(cs.MIXED_IDS)
    ids = torch.arange(cs.ENGINE_MIXED_B, device=dev) % len(cs.MIXED_IDS)
    states, _ = menv.reset_batch(key(20, device=dev), ids)
    max_steps = torch.tensor([m.config.max_steps for m in menv.members], device=dev)[ids]
    states = states.replace(step_count=cs._near_the_end(states.step_count, max_steps, cs.ENGINE_MIXED_T, dev, 20))
    steps = {"finished": menv.autoreset_step(), "every": every_lane_mixed_step(menv)}
    out.append((f"MixedEnv {' + '.join(cs.MIXED_IDS)} regen", cs.ENGINE_MIXED_B, menv.observe, menv.num_actions,
                states, steps))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("autoreset_designs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.rollout import random_policy, run_rollout
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    print(card, flush=True)
    t = cs.ENGINE_T
    for label, b, observe, num_actions, states, steps in cells(dev):
        policy = random_policy(num_actions)

        def call(design):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, m = run_rollout(steps[design], observe, policy, t, key(1990, device=dev), states)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, state_to_numpy(final), [int(x) for x in m[:1] + m[2:4]]

        _, want, want_m = call("finished")
        call("every")
        seconds = {"finished": [], "every": []}
        for design in ("finished", "every", "every", "finished") * args.pairs:
            s, got, got_m = call(design)
            bad = [n for n in want if not (want[n] == got[n]).all()] + (["metrics"] if got_m != want_m else [])
            if bad:
                raise RuntimeError(f"{label}: the {design} design differs: {bad}")
            seconds[design].append(s)
        for design, xs in seconds.items():
            med = statistics.median(xs)
            print(f"{label} B={b} T={t}: {design}: median {med:.6f} s, {b * t / med:.6e} env-steps/s; calls "
                  f"{', '.join(f'{x:.6f}' for x in xs)} [{card}]", flush=True)
        fin, ev = statistics.median(seconds["finished"]), statistics.median(seconds["every"])
        print(f"{label}: every / finished = {ev / fin:.4f}; episodes {want_m[0]} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
