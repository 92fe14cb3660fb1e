"""The reference's executable test sweep on the port (counterpart of the
JAX package's root `run_tests.py`): every registered id, in registration
order, is reset, stepped under random actions, reset twice under one key
and rendered; then the functional wrappers and the class wrappers'
behaviours are checked.

    python -m minigrid_tpu_torch.tools.run_tests               # on the card
    python -m minigrid_tpu_torch.tools.run_tests --device cpu --steps 5

A failed check raises `CheckFailed` (not an `assert`, which `python -O`
strips); the sweep ends with `all tests passed`. The class wrappers
(`compat/host_wrappers.py`) need gymnasium; where it is not installed, the
same two behaviours are checked on `compat/host_env.py::HostEnv` itself
and a line says so.
"""

from __future__ import annotations

import argparse
import importlib.util
import math

import numpy as np
import torch

from minigrid_tpu_torch.core import prng


class CheckFailed(AssertionError):
    """A check of the sweep failed."""


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100, help="random steps an id (default 100)")
    parser.add_argument("--device", default=None, help="a torch device (default: the card)")
    return parser.parse_args(argv)


def check_env(env_id: str, steps: int, rng: np.random.Generator, dev: torch.device) -> None:
    """Reset well-formedness, `steps` random actions drawn from `rng` with
    finite rewards (a reset under `key(t + 1)` on termination),
    determinism under equal keys, and a render at tile 8."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.render.render import render_state

    env = make(env_id)
    state, obs = env.reset(prng.key(0, device=dev))
    v = env.config.agent_view_size
    img = obs["image"]
    check(tuple(img.shape) == (1, v, v, 3), f"{env_id}: reset obs shape {tuple(img.shape)}, want (1, {v}, {v}, 3)")
    check(img.dtype == torch.uint8 and img.device == dev, f"{env_id}: reset obs {img.dtype} on {img.device}")

    s = state
    for t in range(steps):
        a = torch.tensor([int(rng.integers(env.num_actions))], dtype=torch.int32, device=dev)
        s, obs, reward, terminated, truncated = env.step(s, a)
        check(math.isfinite(float(reward[0])), f"{env_id}: step {t} reward {float(reward[0])}")
        if bool(terminated[0]) or bool(truncated[0]):
            s, obs = env.reset(prng.key(t + 1, device=dev))

    _, o1 = env.reset(prng.key(42, device=dev))
    _, o2 = env.reset(prng.key(42, device=dev))
    check(torch.equal(o1["image"], o2["image"]), f"{env_id}: two resets under key(42) differ")

    frame = render_state(state, env.config, tile_size=8)[0]
    want = (env.config.height * 8, env.config.width * 8, 3)
    check(tuple(frame.shape) == want and frame.dtype == torch.uint8,
          f"{env_id}: render {tuple(frame.shape)} {frame.dtype}, want {want} uint8")


def check_wrappers(dev: torch.device) -> None:
    """The six functional wrappers on Empty-8x8: a reset and one step each,
    the observation on `dev`."""
    from minigrid_tpu_torch import make, wrappers

    base = make("MiniGrid-Empty-8x8-v0")
    for name, wrap in (
        ("img_obs", wrappers.img_obs),
        ("full_obs", wrappers.full_obs),
        ("one_hot_partial_obs", wrappers.one_hot_partial_obs),
        ("rgb_img_obs", lambda e: wrappers.rgb_img_obs(e, 8)),
        ("rgb_img_partial_obs", lambda e: wrappers.rgb_img_partial_obs(e, 8)),
        ("view_size", lambda e: wrappers.view_size(e, 5)),
    ):
        wenv = wrap(base)
        st, _ = wenv.reset(prng.key(0, device=dev))
        _, ob, *_ = wenv.step(st, torch.tensor([2], dtype=torch.int32, device=dev))
        img = ob if isinstance(ob, torch.Tensor) else ob["image"]
        check(img.device == dev and img.dtype == torch.uint8, f"{name}: obs {img.dtype} on {img.device}")


def gymnasium_available() -> bool:
    return importlib.util.find_spec("gymnasium") is not None


def check_class_wrappers(dev: torch.device) -> None:
    """`ReseedWrapper` repeats its seed list and `FlatObsWrapper`'s output
    is 1-D; without gymnasium, the seed repeat and `host_env.flat_obs` on
    `HostEnv`."""
    env_id = "MiniGrid-Empty-8x8-v0"
    if gymnasium_available():
        from minigrid_tpu_torch.compat import FlatObsWrapper, ReseedWrapper, gym_make

        genv = ReseedWrapper(gym_make(env_id, device=dev), seeds=[7, 8])
        o1, _ = genv.reset()
        genv.reset()
        o3, _ = genv.reset()
        check(np.array_equal(o1["image"], o3["image"]), "ReseedWrapper: the third reset differs from the first")
        flat, _ = FlatObsWrapper(gym_make(env_id, device=dev)).reset(seed=0)
        check(flat.ndim == 1, f"FlatObsWrapper: {flat.ndim}-D output")
        return
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.compat.host_env import HostEnv, flat_obs

    host = HostEnv(make(env_id), device=dev)
    o1, _ = host.reset(seed=7)
    host.reset(seed=8)
    o3, _ = host.reset(seed=7)
    check(np.array_equal(o1["image"], o3["image"]), "HostEnv: the seed 7 reset does not repeat")
    flat = flat_obs(host.reset(seed=0)[0])
    check(flat.ndim == 1, f"flat_obs: {flat.ndim}-D output")
    print("class wrappers skipped (gymnasium is not installed): checked the seed repeat and flat_obs on HostEnv",
          flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    from minigrid_tpu_torch.envs import registry

    dev = prng.default_device(args.device)
    if dev.type == "cuda" and dev.index is None:  # "cuda": the tensors land on the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    for env_id in registry.env_list:
        print(env_id, flush=True)
        check_env(env_id, args.steps, rng, dev)
    check_wrappers(dev)
    check_class_wrappers(dev)
    print("all tests passed", flush=True)


if __name__ == "__main__":
    main()
