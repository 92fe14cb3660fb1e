"""Drive one env with the keyboard (counterpart of the JAX package's root
`manual_control.py`), through the adapter's per-step path
(`compat/host_env.py::HostEnv`) in a `tools/window.py::Window`.

Keys: left/right turn, up forward, pageup or 'p' pickup, pagedown or 'd'
drop, space toggle, enter done, backspace reset, escape quit.

    python -m minigrid_tpu_torch.tools.manual_control --env-name MiniGrid-MultiRoom-N6-v0
    python -m minigrid_tpu_torch.tools.manual_control --device cpu --agent_view

Runs the env on the card unless `--device` names another device. The
window needs matplotlib and a display; `main(argv, window_factory)` takes
any class with the window's interface, such as `ScriptedWindow`, which
presses a list of keys without either.
"""

from __future__ import annotations

import argparse

from minigrid_tpu_torch.tools.window import Window

KEY_ACTIONS = {
    "left": 0,
    "right": 1,
    "up": 2,
    "pageup": 3,
    "p": 3,
    "pagedown": 4,
    "d": 4,
    " ": 5,
    "enter": 6,
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--env-name", default="MiniGrid-MultiRoom-N6-v0")
    parser.add_argument("--seed", type=int, default=-1)
    parser.add_argument("--tile_size", type=int, default=32)
    parser.add_argument(
        "--agent_view",
        action="store_true",
        help="draw what the agent sees (partially observable view)",
    )
    parser.add_argument("--device", default=None, help="a torch device (default: the card)")
    return parser.parse_args(argv)


def main(argv=None, window_factory=Window):
    """Open the window, reset, and run the key handler until the window
    closes. Returns the `HostEnv`."""
    args = parse_args(argv)
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.compat.host_env import HostEnv

    env = HostEnv(make(args.env_name), device=args.device)
    window = window_factory("minigrid_tpu_torch - " + args.env_name)

    def redraw():
        if args.agent_view:
            from minigrid_tpu_torch.core.obs import gen_obs_image
            from minigrid_tpu_torch.render.render import render_obs_image

            obs_img = gen_obs_image(env.state, env.fenv.config)
            img = render_obs_image(obs_img, tile_size=args.tile_size)[0].cpu().numpy()
        else:
            img = env.render(tile_size=args.tile_size)
        window.set_caption(env.mission)
        window.show_img(img)

    def reset():
        if args.seed != -1:
            env.reset(seed=args.seed)
        else:
            env.reset()
        redraw()

    def step(action):
        _, reward, terminated, truncated, _ = env.step(action)
        print(f"step={env.step_count}, reward={reward:.2f}")
        if terminated or truncated:
            print("done!")
            reset()
        else:
            redraw()

    def key_handler(event):
        key = event.key
        if key == "escape":
            window.close()
        elif key == "backspace":
            reset()
        elif key in KEY_ACTIONS:
            step(KEY_ACTIONS[key])

    window.reg_key_handler(key_handler)
    reset()
    window.show(block=True)
    return env


if __name__ == "__main__":
    main()
