"""Random packed states and exact-sum weights for checking the kernels
against their twins.

`random_packed_case` draws, from a numpy seed, a batch of agent-centred
packed states that reach every branch of the step: border walls; doors
in all three states; keys, balls and boxes (some holding a key or ball);
lava, goal, floor and interior walls; random headings, random carrying
(boxes with contents included) and step counts, half of them within a few
steps of `max_steps`; and a random reset template. The CPU tests feed
these to the JAX package and to the port, and `chip_smoke.py` to the CUDA
kernels and their plain twins.

`dyadic_flax_params` draws `ActorCritic` weights on a sparse dyadic grid,
under which every f32 sum of the actor is exact in any order: the policy
kernel, its twin and the JAX package then agree bit for bit.

`plant_pickup_target` doctors states of a pickup-target family (as the
JAX package's tests do) so that the hook's success fires.

`hooked_packed_case` is `random_packed_case` with aux rows that a family
hook reads as its family lays them out, and the events that make the hook
fire planted near each agent: the target object or door in its forward
cell, the object it must drop in its hands, the target cell within a step
or two, an obstacle in its forward cell.

`obstructed_script_case` is a doctored ObstructedMaze-1Dlhb batch and a
forced action script through its locked door: a key in a grey box toggled
out or carried in its box, the door unlocked, the blue ball picked up.

`moment_gaps` compares two train states' Adam moments leaf by leaf: the
gradient a step used, after the sum over its shards and the clip.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.ops.packing import NUM_REGS, R_AUX, R_CC, R_CT, R_DIR, R_SC, R_X, R_Y

_TYPES = np.array([C.EMPTY, C.WALL, C.FLOOR, C.DOOR, C.KEY, C.BALL, C.BOX, C.GOAL, C.LAVA])
_TYPE_P = np.array([0.40, 0.10, 0.05, 0.15, 0.07, 0.07, 0.07, 0.04, 0.05])
_HELD = np.array([0, C.KEY, C.BALL, C.BOX])  # what the agent may carry
_CONTENTS = np.array([0, C.KEY, C.BALL])  # what a box may hold


def _states(rng: np.random.Generator, width: int, height: int, batch: int, max_steps: int):
    hw = width * height
    t = rng.choice(_TYPES, size=(batch, height, width), p=_TYPE_P)
    t[:, 0, :] = t[:, -1, :] = C.WALL
    t[:, :, 0] = t[:, :, -1] = C.WALL
    color = rng.integers(0, 6, size=t.shape)
    color = np.where(t == C.WALL, C.GREY, color)
    state = np.where(t == C.DOOR, rng.integers(0, 3, size=t.shape), 0)
    cont = np.where(t == C.BOX, rng.choice(_CONTENTS, size=t.shape), 0)
    cont_color = np.where(cont > 0, rng.integers(0, 6, size=t.shape), 0)

    x = rng.integers(1, width - 1, size=batch)
    y = rng.integers(1, height - 1, size=batch)
    lanes = np.arange(batch)
    t[lanes, y, x] = C.EMPTY  # the agent stands on an empty cell
    color[lanes, y, x] = state[lanes, y, x] = cont[lanes, y, x] = cont_color[lanes, y, x] = 0

    words = t | (color << 4) | (state << 8) | (cont << 12) | (cont_color << 16)
    words = words.reshape(batch, hw).T.astype(np.int32)  # (HW, B)
    base = y * width + x
    words = words[(np.arange(hw)[:, None] + base[None, :]) % hw, lanes[None, :]]  # agent-centred

    ct = rng.choice(_HELD, size=batch)
    cc = np.where(ct > 0, rng.integers(0, 6, size=batch), 0)
    cct = np.where(ct == C.BOX, rng.choice(_CONTENTS, size=batch), 0)
    ccc = np.where(cct > 0, rng.integers(0, 6, size=batch), 0)
    near_end = rng.integers(max(0, max_steps - 8), max_steps, size=batch)
    anywhere = rng.integers(0, max_steps, size=batch)
    sc = np.where(rng.random(batch) < 0.5, near_end, anywhere)
    d = rng.integers(0, 4, size=batch)

    regs = np.empty((NUM_REGS, batch), np.int32)
    regs[:R_AUX] = np.stack([x, y, d, ct, cc, cct, ccc, sc])
    regs[R_AUX:] = rng.integers(-(2**31), 2**31, size=(NUM_REGS - R_AUX, batch), dtype=np.int64)
    return np.ascontiguousarray(words), regs


def random_packed_case(
    seed: int, width: int, height: int, batch: int, max_steps: int
) -> Dict[str, np.ndarray]:
    """`{"words", "regs", "tmpl_words", "tmpl_regs"}`: int32 numpy arrays
    in the packed agent-centred layout, `(HW, B)` and `(NUM_REGS, B)`."""
    rng = np.random.default_rng(seed)
    words, regs = _states(rng, width, height, batch, max_steps)
    tmpl_words, tmpl_regs = _states(rng, width, height, batch, max_steps)
    tmpl_regs[R_SC] = 0
    return dict(words=words, regs=regs, tmpl_words=tmpl_words, tmpl_regs=tmpl_regs)


def plant_pickup_target(states: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A copy of a state dictionary (`utils.convert.state_to_numpy`'s) with
    every agent at (1, 1) facing right, hands free, at its aux target
    (type `aux[0]`, colour `aux[1]`) planted at (2, 1): a pickup there
    succeeds."""
    s = {k: np.array(v) for k, v in states.items()}
    s["agent_pos"][:] = 1
    s["agent_dir"][:] = 0
    s["grid"][:, 1, 2, :] = 0
    s["grid"][:, 1, 2, 0] = s["aux"][:, 0]
    s["grid"][:, 1, 2, 1] = s["aux"][:, 1]
    s["carrying"][:] = 0
    return s


def _sparse_dyadic(rng: np.random.Generator, n_in: int, n_out: int, nnz: int, steps, scale: float):
    """`(n_in, n_out)` float32: `nnz` non-zeros per column, each
    `±j · scale` with `j` drawn from `steps`."""
    k = np.zeros((n_in, n_out), np.float32)
    for o in range(n_out):
        rows = rng.choice(n_in, size=nnz, replace=False)
        k[rows, o] = rng.choice(steps, size=nnz) * rng.choice([-1, 1], size=nnz) * scale
    return k


def dyadic_flax_params(seed: int, view: int = 7, num_actions: int = 7, hidden: int = 256):
    """A flax `ActorCritic` params tree of numpy float32 arrays whose values
    are small multiples of powers of two with few non-zeros per unit, so
    that the actor's f32 sums (and so the logits) are exact in any order:
    torso entries in quarters, head entries in sixteenths."""
    rng = np.random.default_rng(seed)
    n_in = view * view * 20

    def bias(n, scale):
        return (rng.integers(-2, 3, size=n) * scale).astype(np.float32)

    return {"params": {
        "torso_0": {"kernel": _sparse_dyadic(rng, n_in, hidden, 4, [1, 2, 3, 4], 0.25), "bias": bias(hidden, 0.25)},
        "torso_1": {"kernel": _sparse_dyadic(rng, hidden, hidden, 4, [1, 2, 3, 4], 0.25), "bias": bias(hidden, 0.25)},
        "actor": {"kernel": _sparse_dyadic(rng, hidden, num_actions, 8, [1, 2], 1 / 16), "bias": bias(num_actions, 1 / 16)},
        "critic": {"kernel": _sparse_dyadic(rng, hidden, 1, 8, [1, 2], 1 / 16), "bias": bias(1, 1 / 16)},
    }}


def _plant(words: np.ndarray, regs: np.ndarray, width: int, x, y, word, lanes) -> None:
    """Write `word` at the absolute cell `(x, y)` of the agent-centred
    `words` of `lanes` (a bool mask), in place."""
    hw = words.shape[0]
    base = regs[R_Y] * width + regs[R_X]
    rows = (np.asarray(y) * width + np.asarray(x) - base) % hw
    idx = np.nonzero(lanes)[0]
    words[rows[idx], idx] = np.broadcast_to(word, lanes.shape)[idx]


def _off_cell(rng, x, y, fx, fy, width: int, height: int):
    """A random cell per lane that is neither the agent's nor its forward
    cell."""
    ox = rng.integers(0, width, size=x.shape)
    oy = rng.integers(0, height, size=x.shape)
    clash = ((ox == x) & (oy == y)) | ((ox == fx) & (oy == fy))
    return np.where(clash, np.where(x > 1, 0, width - 1), ox), oy


def _obstacles(rng, words, regs, width: int, height: int, n: int, front) -> None:
    """n distinct interior cells per lane, off the agent's, as obstacle
    balls in the aux rows and on the grid; obstacle 0 in the forward cell
    of the `front` lanes where that cell is interior."""
    b = words.shape[1]
    x, y, d = regs[R_X], regs[R_Y], regs[R_DIR]
    fx, fy = x + np.array([1, 0, -1, 0])[d], y + np.array([0, 1, 0, -1])[d]
    xs, ys = np.arange(width * height) % width, np.arange(width * height) // width
    interior = (xs >= 1) & (xs <= width - 2) & (ys >= 1) & (ys <= height - 2)
    score = rng.random((b, width * height))
    score[:, ~interior] = np.inf
    lanes = np.arange(b)
    score[lanes, y * width + x] = np.inf
    in_front = front & (fx >= 1) & (fx <= width - 2) & (fy >= 1) & (fy <= height - 2)
    score[lanes[in_front], (fy * width + fx)[in_front]] = -1.0
    cells = np.argsort(score, axis=1)[:, :n]
    for i in range(n):
        ox, oy = cells[:, i] % width, cells[:, i] // width
        regs[R_AUX + 2 * i], regs[R_AUX + 2 * i + 1] = ox, oy
        _plant(words, regs, width, ox, oy, np.full(b, C.BALL | (C.BLUE << 4)), np.ones(b, bool))


def _hook_events(rng: np.random.Generator, transition: str, words, regs, width: int, height: int,
                 n_obstacles: int = 0) -> None:
    """Set the aux rows `transition`'s hook reads and plant its events, in
    place, for one packed state batch."""
    b = words.shape[1]
    x, y, d = regs[R_X], regs[R_Y], regs[R_DIR]
    dx = np.array([1, 0, -1, 0])[d]
    dy = np.array([0, 1, 0, -1])[d]
    fx, fy = x + dx, y + dy
    half = rng.random(b) < 0.5
    aux = regs[R_AUX:]
    if transition in ("pickup_target", "fetch"):
        aux[0] = rng.choice([C.KEY, C.BALL, C.BOX], size=b)
        aux[1] = rng.integers(0, 6, size=b)
        # Half the lanes face their target with free hands.
        _plant(words, regs, width, fx, fy, aux[0] | (aux[1] << 4), half)
        regs[R_CT][half] = regs[R_CC][half] = 0
    elif transition in ("gotodoor", "gotoobject"):
        aux[0] = x + rng.integers(-2, 3, size=b)
        aux[1] = y + rng.integers(-2, 3, size=b)
    elif transition == "putnear":
        # Half the lanes carry the object to move; the target lies within
        # two cells of the forward cell.
        aux[0] = np.where(half, regs[R_CT], rng.choice([C.KEY, C.BALL, C.BOX], size=b))
        aux[1] = np.where(half, regs[R_CC], rng.integers(0, 6, size=b))
        aux[2] = fx + rng.integers(-2, 3, size=b)
        aux[3] = fy + rng.integers(-2, 3, size=b)
        _plant(words, regs, width, fx, fy, np.full(b, C.EMPTY), half)
    elif transition == "redbluedoors":
        # One door in the forward cell, the other on a random cell off the
        # agent's, each open, closed or locked.
        ox, oy = _off_cell(rng, x, y, fx, fy, width, height)
        red_front = half
        aux[0], aux[1] = np.where(red_front, fx, ox), np.where(red_front, fy, oy)
        aux[2], aux[3] = np.where(red_front, ox, fx), np.where(red_front, oy, fy)
        for (ax, ay), color in (((aux[0], aux[1]), C.RED), ((aux[2], aux[3]), C.BLUE)):
            state = rng.integers(0, 3, size=b)
            _plant(words, regs, width, ax, ay, C.DOOR | (color << 4) | (state << 8), np.ones(b, bool))
    elif transition == "memory":
        # Half the lanes face their success cell, the rest their failure
        # cell, each free to step on; the other cell lies within two cells.
        ox, oy = x + rng.integers(-2, 3, size=b), y + rng.integers(-2, 3, size=b)
        aux[0], aux[1] = np.where(half, fx, ox), np.where(half, fy, oy)
        aux[2], aux[3] = np.where(half, ox, fx), np.where(half, oy, fy)
        _plant(words, regs, width, fx, fy, np.full(b, C.EMPTY), np.ones(b, bool))
    elif transition == "unlock":
        # The door in the forward cell of half the lanes, on a random cell
        # off the agent's elsewhere; open, closed or locked.
        ox, oy = _off_cell(rng, x, y, fx, fy, width, height)
        aux[0], aux[1] = np.where(half, fx, ox), np.where(half, fy, oy)
        door = C.DOOR | (rng.integers(0, 6, size=b) << 4) | (rng.integers(0, 3, size=b) << 8)
        _plant(words, regs, width, aux[0], aux[1], door, np.ones(b, bool))
    elif transition == "dynamicobstacles":
        if n_obstacles < 1:
            raise ValueError("the dynamicobstacles case needs n_obstacles")
        _obstacles(rng, words, regs, width, height, n_obstacles, half)
    else:
        raise ValueError(f"no planted events for transition {transition!r}")


def hooked_packed_case(
    seed: int, transition: str, width: int, height: int, batch: int, max_steps: int, n_obstacles: int = 0
) -> Dict[str, np.ndarray]:
    """`random_packed_case` whose live states and templates carry the aux
    rows `transition`'s hook reads, with its events planted (see the
    module docstring); `n_obstacles` is the DynamicObstacles count."""
    case = random_packed_case(seed, width, height, batch, max_steps)
    rng = np.random.default_rng(seed + 1)
    for w, r in (("words", "regs"), ("tmpl_words", "tmpl_regs")):
        _hook_events(rng, transition, case[w], case[r], width, height, n_obstacles)
    return case


OBSTRUCTED_ID = "MiniGrid-ObstructedMaze-1Dlhb-v0"


def obstructed_script_case(copies: int = 1):
    """`(states, actions)`: a doctored ObstructedMaze-1Dlhb batch (a state
    dictionary as `utils.convert.state_to_numpy` gives it) of two layouts,
    tiled `copies` times, and the `(10, 2·copies)` int32 actions that drive
    it through the locked door at (5, dy).

    Each layout is the port's generator's (`reset_batch(key(0))`) with both
    rooms emptied, the agent at (3, dy) facing the door, a grey box holding
    the door's key at (4, dy) and the blue ball at (7, dy).
      * lane 0: toggle the box (the key appears), pick the key up, step
        forward, unlock the door, walk through it, drop the key beside the
        path and pick the ball up: the pickup-target reward.
      * lane 1: pick the box up with the key inside, drop it beside the
        path, toggle it, pick the key up, unlock the door, walk through it.
    """
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.envs.registry import make
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    s = state_to_numpy(make(OBSTRUCTED_ID).reset_batch(key(0, device=torch.device("cpu")), 2)[0])
    g = s["grid"]
    actions = np.zeros((10, 2), np.int32)
    for b in range(2):
        dy = int(np.flatnonzero(g[b, :, 5, 0] == C.DOOR)[0])
        color = g[b, dy, 5, 1]
        for x0, x1 in ((1, 5), (6, 10)):
            g[b, 1:5, x0:x1] = (C.EMPTY, 0, 0, 0, 0)
        g[b, dy, 4] = (C.BOX, C.GREY, 0, C.KEY, color)
        g[b, dy, 7] = (C.BALL, C.BLUE, 0, 0, 0)
        s["agent_pos"][b] = (3, dy)
        s["agent_dir"][b] = 0
        side, back = (0, 1) if dy >= 2 else (1, 0)  # turn towards the free row beside the path and back
        if b == 0:
            actions[:, b] = (5, 3, 2, 5, 2, 2, side, 4, back, 3)
        else:
            actions[:, b] = (3, side, 4, 5, 3, back, 2, 5, 2, 2)
    s["carrying"][:] = 0
    s["step_count"][:] = 0
    s = {k: np.concatenate([v] * copies) for k, v in s.items()}
    return s, np.tile(actions, (1, copies))


def moment_gaps(ts, ref) -> Dict[str, list]:
    """Adam's `mu` and `nu` in train state `ts` against those in `ref`
    (`parallel/train.py::TrainState`), per flax leaf `"layer/leaf"`: `[mu
    gap, nu gap]`, each the largest gap relative to the leaf's largest
    entry in `ref`."""
    from minigrid_tpu_torch.parallel.train import _flax_names

    tree, off, gaps = ref.params.flax_params(), 0, {}
    for n, k in _flax_names(tree):
        size = tree["params"][n][k].numel()
        sl = slice(off, off + size)
        off += size
        gaps[f"{n}/{k}"] = [
            float((getattr(ts.opt_state, m)[sl] - getattr(ref.opt_state, m)[sl]).abs().max()
                  / getattr(ref.opt_state, m)[sl].abs().max().clamp_min(1e-30))
            for m in ("mu", "nu")
        ]
    return gaps
