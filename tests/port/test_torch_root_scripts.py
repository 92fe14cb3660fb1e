"""The root scripts on the port (`minigrid_tpu_torch/tools/benchmark.py`,
`run_tests.py`, `manual_control.py`), on the CPU.

  * benchmark: `main` at tiny sizes prints the device line and the
    reference's four lines; its timed batched call's states and metrics
    equal the JAX package's `build_rollout` on Empty-8x8 at B = 8, T = 4
    under the same keys (one cached `jax.jit`).
  * run_tests: the ids it walks are the JAX registry's, in its order;
    three ids pass at `--steps 5`, with and without gymnasium; a step that
    pays a NaN reward makes it raise.
  * manual_control: every key drives `HostEnv` with its action, backspace
    resets with the seed and escape closes the window; each redraw equals
    `HostEnv.render`, or with `--agent_view` `render_obs_image(gen_obs_image(...))`.
  * Without `--device` each script raises where there is no card.

The `gpu` cases run each script on the card against the CPU.
"""

import functools

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.envs import base, registry
from minigrid_tpu_torch.tools import benchmark as bm
from minigrid_tpu_torch.tools import manual_control as mc
from minigrid_tpu_torch.tools import run_tests as rt
from minigrid_tpu_torch.tools.window import ScriptedWindow
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_to_numpy

BENCH_ID, BENCH_B, BENCH_T = "MiniGrid-Empty-8x8-v0", 8, 4
BENCH_ARGS = ["--env-name", BENCH_ID, "--num_resets", "2", "--num_frames", "12", "--batch-size", str(BENCH_B),
              "--batched-steps", str(BENCH_T)]
CHECK_IDS = ("MiniGrid-DoorKey-5x5-v0", "MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0")
ALL_KEYS = ["left", "right", "up", "pageup", "p", "pagedown", "d", " ", "enter"]
CONTROL_ID, CONTROL_SEED = "MiniGrid-DoorKey-5x5-v0", 5


@functools.lru_cache(maxsize=None)
def _jax_benchmark_rollout():
    """The JAX benchmark's batched part: `reset_batch(key, B)`, the call
    that is not timed, then the timed one under `fold_in(key, 1)`."""
    import jax

    import minigrid_tpu
    from minigrid_tpu.core.rollout import build_rollout

    env = minigrid_tpu.make(BENCH_ID)
    rollout = build_rollout(env, num_steps=BENCH_T)

    def run(key):
        states, _ = env.reset_batch(key, BENCH_B)
        states, _ = rollout(key, states)
        return rollout(jax.random.fold_in(key, 1), states)

    return jax.jit(run)


def test_benchmark_prints_its_lines_and_matches_jax(capsys):
    import jax

    res = bm.main(BENCH_ARGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Device        : cpu"
    assert [line.split(":")[0] for line in lines[1:]] == ["Env reset time", "Single-env FPS", "Render FPS    ",
                                                         "Batched FPS   "]
    assert lines[-1].endswith(f"(B={BENCH_B} on cpu)")
    assert all(x > 0 and np.isfinite(x) for x in res[:4])
    jstates, jm = _jax_benchmark_rollout()(jax.random.PRNGKey(0))
    got = state_to_numpy(res.states)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jstates, name)), err_msg=name)
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        assert int(getattr(res.metrics, name)) == int(getattr(jm, name)), name
    assert int(res.metrics.total_steps) == BENCH_B * BENCH_T
    np.testing.assert_allclose(float(res.metrics.total_reward), float(jm.total_reward), rtol=1e-6, atol=0)


def test_run_tests_walks_the_jax_registry_in_order(monkeypatch, capsys):
    from minigrid_tpu.envs.registry import env_list as jax_env_list

    walked = []
    monkeypatch.setattr(rt, "check_env", lambda env_id, steps, rng, dev: walked.append((env_id, steps, dev)))
    monkeypatch.setattr(rt, "check_wrappers", lambda dev: None)
    monkeypatch.setattr(rt, "check_class_wrappers", lambda dev: None)
    rt.main(["--device", "cpu"])
    assert [w[0] for w in walked] == list(jax_env_list) and len(walked) == 70
    assert {w[1:] for w in walked} == {(100, torch.device("cpu"))}
    assert capsys.readouterr().out.splitlines() == list(jax_env_list) + ["all tests passed"]


@pytest.mark.parametrize("gymnasium", [True, False], ids=["gymnasium", "no_gymnasium"])
def test_run_tests_passes_three_ids(gymnasium, monkeypatch, capsys):
    monkeypatch.setattr(rt, "gymnasium_available", lambda: gymnasium)
    monkeypatch.setattr(registry, "env_list", list(CHECK_IDS))
    rt.main(["--device", "cpu", "--steps", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == list(CHECK_IDS) and lines[-1] == "all tests passed"
    skipped = [line for line in lines if line.startswith("class wrappers skipped")]
    assert len(skipped) == (0 if gymnasium else 1)


def test_run_tests_raises_on_a_nan_reward(monkeypatch):
    step = base.Env.step

    def nan_step(self, state, action):
        state, obs, reward, terminated, truncated = step(self, state, action)
        return state, obs, torch.full_like(reward, float("nan")), terminated, truncated

    monkeypatch.setattr(base.Env, "step", nan_step)
    with pytest.raises(rt.CheckFailed, match="MiniGrid-Empty-5x5-v0: step 0 reward nan"):
        rt.main(["--device", "cpu", "--steps", "3"])


def _drive(device, agent_view, keys):
    windows = []

    def factory(title):
        windows.append(ScriptedWindow(title, keys))
        return windows[-1]

    argv = ["--env-name", CONTROL_ID, "--seed", str(CONTROL_SEED), "--tile_size", "8", "--device", device]
    env = mc.main(argv + (["--agent_view"] if agent_view else []), window_factory=factory)
    assert len(windows) == 1 and windows[0].title == f"minigrid_tpu_torch - {CONTROL_ID}"
    return env, windows[0]


@pytest.mark.parametrize("agent_view", [False, True], ids=["full", "agent_view"])
def test_manual_control_keys_drive_host_env(agent_view, capsys):
    """Each key once, backspace, escape, then a key the closed window never
    sends; the same actions through a `HostEnv` of its own give every
    frame and caption."""
    from minigrid_tpu_torch.compat.host_env import HostEnv
    from minigrid_tpu_torch.core.obs import gen_obs_image
    from minigrid_tpu_torch.render.render import render_obs_image

    env, window = _drive("cpu", agent_view, ALL_KEYS + ["backspace", "escape", "up"])
    assert window.closed and env.step_count == 0

    ref = HostEnv(make(CONTROL_ID), device="cpu")

    def shown():
        if agent_view:
            return render_obs_image(gen_obs_image(ref.state, ref.fenv.config), tile_size=8)[0].numpy()
        return ref.render(tile_size=8)

    ref.reset(seed=CONTROL_SEED)
    frames, steps = [shown()], []
    for k in ALL_KEYS:
        _, r, te, tr, _ = ref.step(mc.KEY_ACTIONS[k])
        steps.append(f"step={ref.step_count}, reward={r:.2f}")
        if te or tr:
            steps.append("done!")
            ref.reset(seed=CONTROL_SEED)
        frames.append(shown())
    ref.reset(seed=CONTROL_SEED)
    frames.append(shown())
    assert [mc.KEY_ACTIONS[k] for k in ALL_KEYS] == [0, 1, 2, 3, 3, 4, 4, 5, 6]
    assert len(window.frames) == len(frames) == len(ALL_KEYS) + 2
    for i, (got, want) in enumerate(zip(window.frames, frames)):
        assert got.dtype == np.uint8 and np.array_equal(got, want), i
    assert window.captions == [ref.mission] * len(frames)
    assert capsys.readouterr().out.splitlines() == steps
    assert not all(np.array_equal(window.frames[0], f) for f in window.frames[1:])


@pytest.mark.parametrize("script", ["benchmark", "run_tests", "manual_control"])
def test_scripts_raise_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the scripts run on it")
    run = {"benchmark": bm.main, "run_tests": rt.main,
           "manual_control": lambda argv: mc.main(argv, window_factory=ScriptedWindow)}[script]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["--env-name", "MiniGrid-Empty-5x5-v0"] if script != "run_tests" else [])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_benchmark_on_the_card_matches_the_cpu():
    _needs_card()
    card, cpu = bm.main(BENCH_ARGS + ["--device", "cuda"]), bm.main(BENCH_ARGS + ["--device", "cpu"])
    assert card.states.grid.device.type == "cuda"
    got, want = state_to_numpy(card.states), state_to_numpy(cpu.states)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        assert int(getattr(card.metrics, name)) == int(getattr(cpu.metrics, name)), name
    np.testing.assert_allclose(float(card.metrics.total_reward), float(cpu.metrics.total_reward), rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_run_tests_on_the_card(capsys, monkeypatch):
    _needs_card()
    monkeypatch.setattr(registry, "env_list", list(CHECK_IDS))
    rt.main(["--device", "cuda", "--steps", "5"])
    assert capsys.readouterr().out.splitlines()[-1] == "all tests passed"


@pytest.mark.gpu
@pytest.mark.parametrize("agent_view", [False, True], ids=["full", "agent_view"])
def test_manual_control_on_the_card_matches_the_cpu(agent_view):
    _needs_card()
    keys = ALL_KEYS + ["backspace", "escape"]
    (card_env, card), (_, cpu) = _drive("cuda", agent_view, keys), _drive("cpu", agent_view, keys)
    assert card_env.device.type == "cuda" and card.captions == cpu.captions
    assert len(card.frames) == len(cpu.frames) == len(keys)
    assert all(np.array_equal(a, b) for a, b in zip(card.frames, cpu.frames))
