"""Plain reference of the two gridworlds the benchmark runs: Threefry's key
chain, Empty's and DoorKey's generation, the packed lane layout, the step
with its auto-reset and the egocentric view with its checksum.

Frozen copies of the semantics, in plain torch ops on `(rows, B)` tensors
and importing nothing of the program: the reference MiniGrid
(gym-minigrid's `MiniGridEnv.step`, `gen_obs_grid`, `Grid.process_vis`,
`EmptyEnv._gen_grid`, `DoorKeyEnv._gen_grid`) under `jax.random`'s
Threefry-2x32 draws, as the ported package lays them out:

* keys are `(B, 2)` int64 tensors of uint32 words; `split(k, n)` is
  `threefry2x32(k, (0, c))` for child `c`; `randint` reduces two draws as
  `jax.random.randint` does; a uniform cell is the first index of the
  largest `bits >> 9` over the allowed cells (`jax.random.categorical` over
  a 0 / -inf mask);
* a grid cell is one int32 word `type | colour << 4 | state << 8 |
  contained type << 12 | contained colour << 16`, the grid `(H*W, B)`
  with row `y*W + x`, rolled per lane so that row 0 is the agent's cell;
* the registers are `(42, B)` int32: x, y, heading, the carried object's
  four fields, the step count, 24 auxiliary rows, the 8-row mission and the
  lane's key as two int32 rows.

A reset installs the lane's template (the layout its key generates) and,
in regen mode, moves the lane's key one link down its chain, `rng <-
split(rng)[1]`, so that every reset has a fresh layout.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Object, colour and state ids (gym-minigrid's OBJECT_TO_IDX, COLOR_TO_IDX,
# STATE_TO_IDX).
EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA = 1, 2, 3, 4, 5, 6, 7, 8, 9
GREEN, YELLOW, GREY = 1, 4, 5
STATE_OPEN, STATE_LOCKED = 0, 2
DIR_TO_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))  # right, down, left, up

WALL_WORD = WALL | (GREY << 4)
GOAL_WORD = GOAL | (GREEN << 4)
DOOR_LOCKED_WORD = DOOR | (YELLOW << 4) | (STATE_LOCKED << 8)
KEY_WORD = KEY | (YELLOW << 4)

# Register rows.
R_X, R_Y, R_DIR, R_CT, R_CC, R_CCT, R_CCC, R_SC = range(8)
R_AUX, AUX_LEN = 8, 24
R_MISSION, MISSION_LEN = 32, 8
R_RNG = 40
NUM_REGS = 42

# Mission template ids (the index of each family's mission string in the
# table of mission templates).
MISSION_IDS = {"empty": 1, "doorkey": 5}


# ---------------------------------------------------------------- Threefry

def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors of uint32 values."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device)
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=k0.device)
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=k0.device)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def seed_key(seed: int, device) -> torch.Tensor:
    """`PRNGKey(seed)` of a seed in `[0, 2**64)`: its high and low words."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`(..., 2)` keys -> `(..., n, 2)` children."""
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(c), c)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor) -> torch.Tensor:
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return x0 ^ x1


def randint(keys: torch.Tensor, lo: int, hi) -> torch.Tensor:
    """`randint(key, (), lo, hi)` per key; `hi` an int or a `(B,)` tensor."""
    halves = split(keys, 2)
    higher, lower = bits(halves[..., 0, :]), bits(halves[..., 1, :])
    hi = torch.as_tensor(hi, dtype=torch.int64, device=keys.device)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    mult = (65536 % span) ** 2 % span
    off = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    return (lo + off % span).to(torch.int32)


def uniform_index(keys: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """A uniform draw over the True entries of each row of `(B, N)` bool
    (over all N where a row has none): the first index of the largest
    `bits >> 9` of counters `(0, i)`."""
    n = allowed.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], 0, idx)
    m = (x0 ^ x1) >> 9
    ok = allowed | ~allowed.any(dim=1, keepdim=True)
    return torch.where(ok, m * n + (n - 1 - idx), -1).argmax(dim=1)


def key_rows(rng: torch.Tensor) -> torch.Tensor:
    r = rng.T
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)


def rows_key(rows: torch.Tensor) -> torch.Tensor:
    return (rows.to(torch.int64) & MASK32).T.contiguous()


# -------------------------------------------------------------- generation

def _grid_xy(width: int, height: int, device):
    k = torch.arange(width * height, dtype=torch.int64, device=device)
    return (k % width)[None, :], (k // width)[None, :]  # (1, HW) each


def generate(family: str, keys: torch.Tensor, width: int, height: int):
    """The layouts of a `(B, 2)` batch of keys: `(words (B, HW) int32, x,
    y, heading (B,) int32, next key (B, 2))`, unrolled."""
    b, dev = keys.shape[0], keys.device
    xs, ys = _grid_xy(width, height, dev)
    border = (xs == 0) | (xs == width - 1) | (ys == 0) | (ys == height - 1)
    words = torch.where(border, WALL_WORD, EMPTY).to(torch.int32).expand(b, -1).clone()
    goal = (xs == width - 2) & (ys == height - 2)
    words = torch.where(goal, GOAL_WORD, words).to(torch.int32)
    halves = split(keys, 2)
    key, nxt = halves[:, 0], halves[:, 1]
    if family == "empty":
        one = torch.ones(b, dtype=torch.int32, device=dev)
        return words, one, one.clone(), torch.zeros_like(one), nxt
    if family != "doorkey":
        raise ValueError(f"no reference generator for {family!r}")
    ks = split(key, 5)
    split_x = randint(ks[:, 0], 2, width - 2)[:, None]
    words = torch.where(xs == split_x, WALL_WORD, words).to(torch.int32)
    left = xs < split_x
    free = (words & 15) == EMPTY
    a = uniform_index(ks[:, 1], free & left)
    ax, ay = (a % width).to(torch.int32), (a // width).to(torch.int32)
    heading = randint(ks[:, 2], 0, 4)
    door_y = randint(ks[:, 3], 1, width - 2)[:, None]
    words = torch.where((xs == split_x) & (ys == door_y), DOOR_LOCKED_WORD, words).to(torch.int32)
    free = ((words & 15) == EMPTY) & ~((xs == ax[:, None]) & (ys == ay[:, None]))
    k = uniform_index(ks[:, 4], free & left)[:, None]
    words = torch.where((xs == k % width) & (ys == k // width), KEY_WORD, words).to(torch.int32)
    return words, ax, ay, heading, nxt


def roll_to(words: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """`out[s, b] = words[(base[b] + s) % HW, b]`."""
    hw = words.shape[0]
    rows = torch.arange(hw, dtype=torch.int64, device=words.device)[:, None]
    return torch.gather(words, 0, (rows + base.reshape(1, -1).to(torch.int64)) % hw)


def packed_layouts(family: str, keys: torch.Tensor, width: int, height: int):
    """`(words (HW, B), regs (42, B))` of the fresh states that `keys`
    generate, rolled to their agents: what a reset installs."""
    g, x, y, heading, nxt = generate(family, keys, width, height)
    b, dev = keys.shape[0], keys.device
    regs = torch.zeros((NUM_REGS, b), dtype=torch.int32, device=dev)
    regs[R_X], regs[R_Y], regs[R_DIR] = x, y, heading
    regs[R_MISSION] = MISSION_IDS[family]
    regs[R_RNG : R_RNG + 2] = key_rows(nxt)
    return roll_to(g.T.contiguous(), y * width + x).contiguous(), regs


# -------------------------------------------------------------------- step

def _sel4(d, vals):
    return torch.where(d == 0, vals[0], torch.where(d == 1, vals[1], torch.where(d == 2, vals[2], vals[3])))


def _offsets(width: int, height: int, view: int):
    """The rolled row of the forward cell and of each view cell, per
    heading; and each view cell's forward and lateral distance."""
    hw, half = width * height, view // 2
    k = torch.arange(view * view)
    fwd_dist = (view - 1) - k // view
    lateral = k % view - half
    off_fwd, off_view = [], []
    for f0, f1 in DIR_TO_VEC:
        dx = f0 * fwd_dist - f1 * lateral
        dy = f1 * fwd_dist + f0 * lateral
        off_view.append((dy * width + dx) % hw)
        off_fwd.append((f1 * width + f0) % hw)
    return off_fwd, torch.cat(off_view), fwd_dist, lateral


def _roll_rows(x, k):
    k %= x.shape[0]
    return x if k == 0 else torch.cat([x[k:], x[:k]], dim=0)


def visibility(trans_rows: torch.Tensor, view: int) -> torch.Tensor:
    """gym-minigrid's `process_vis` on V-bit row masks: bit i of row j is
    set where view cell (j, i) is transparent; the agent at (V-1, V//2)."""
    full = (1 << view) - 1
    carry = torch.zeros_like(trans_rows[0])
    out = [None] * view
    for j in range(view - 1, -1, -1):
        row = carry | (1 << (view // 2)) if j == view - 1 else carry
        t = trans_rows[j]
        for _ in range(view - 1):
            row = row | ((row & t) << 1)
        row = row & full
        q_l = row & t & (full >> 1)
        for _ in range(view - 1):
            row = row | ((row & t) >> 1)
        q_r = row & t & (full & ~1)
        carry = (q_l | (q_l << 1) | q_r | (q_r >> 1)) & full
        out[j] = row
    return torch.stack(out)


def observe(words, regs, width: int, height: int, view: int, see_through_walls: bool):
    """The egocentric V x V view of every lane, `(V², B)` int32 words of
    view cell `(row j, col i)` at `j·V + i` (the agent at `(V-1, V//2)`):
    walls outside the grid, the carried object on the agent's cell, and
    `(type, colour, state)` zeroed where occluded."""
    _, off_view, fwd_dist, lateral = _offsets(width, height, view)
    dev, v2 = words.device, view * view
    fwd_dist, lateral = fwd_dist.to(dev)[:, None], lateral.to(dev)[:, None]
    d = regs[R_DIR : R_DIR + 1]
    vw = _sel4(d, [words[off_view[i * v2 : (i + 1) * v2].to(dev)] for i in range(4)])
    f0 = (d == 0).int() - (d == 2).int()
    f1 = (d == 1).int() - (d == 3).int()
    wx = regs[R_X : R_X + 1] + f0 * fwd_dist - f1 * lateral
    wy = regs[R_Y : R_Y + 1] + f1 * fwd_dist + f0 * lateral
    vw = torch.where((wx >= 0) & (wx < width) & (wy >= 0) & (wy < height), vw, WALL_WORD)
    ct, cc = regs[R_CT : R_CT + 1], regs[R_CC : R_CC + 1]
    agent = (torch.arange(v2, device=dev) == (view - 1) * view + view // 2)[:, None]
    vw = torch.where(agent, torch.where(ct > 0, ct | (cc << 4), EMPTY), vw) & 0xFFF
    if see_through_walls:
        return vw
    vt, vs = vw & 15, (vw >> 8) & 15
    trans = (~((vt == WALL) | ((vt == DOOR) & (vs != STATE_OPEN)))).int()
    col = torch.arange(v2, device=dev)[:, None] % view
    rows = (trans << col).reshape(view, view, -1).sum(dim=1, dtype=torch.int32)
    return vw * ((visibility(rows, view).repeat_interleave(view, dim=0) >> col) & 1)


def checksum(obs: torch.Tensor) -> torch.Tensor:
    """A view's checksum, type + colour + state over its cells, `(1, B)`."""
    return ((obs & 15) + ((obs >> 4) & 15) + ((obs >> 8) & 15)).sum(dim=0, keepdim=True, dtype=torch.int32)


def step(words, regs, a, tmpl_words, tmpl_regs, width, height, view, max_steps, see_through_walls,
         reward_dtype=torch.float32):
    """One step of every lane under its action `a` `(1, B)` int32, then
    the auto-reset to the template of the lanes whose episode ended, and
    the post-step view. Returns `(words, regs, reward (1, B) f32, done
    (1, B) bool, view (V², B) int32)`. `reward_dtype` is the precision the
    reward is computed in (f32 as configured)."""
    hw = width * height
    off_fwd, _, _, _ = _offsets(width, height, view)
    dev = words.device
    x, y, d = regs[R_X : R_X + 1], regs[R_Y : R_Y + 1], regs[R_DIR : R_DIR + 1]
    ct, cc, cct, ccc = (regs[r : r + 1] for r in (R_CT, R_CC, R_CCT, R_CCC))
    sc = regs[R_SC : R_SC + 1]
    fwd = _sel4(d, [words[o : o + 1] for o in off_fwd])
    ft, fc, fs = fwd & 15, (fwd >> 4) & 15, (fwd >> 8) & 15
    fct, fcc = (fwd >> 12) & 15, (fwd >> 16) & 15

    left, right, forward, pickup, drop, toggle = (a == i for i in range(6))
    d1 = torch.where(right, d + 1, torch.where(left, d + 3, d)) % 4
    passable = (ft == EMPTY) | (ft == FLOOR) | (ft == GOAL) | (ft == LAVA) | ((ft == DOOR) & (fs == STATE_OPEN))
    moves = forward & passable
    dx = (d == 0).int() - (d == 2).int()
    dy = (d == 1).int() - (d == 3).int()
    x1, y1 = torch.where(moves, x + dx, x), torch.where(moves, y + dy, y)
    sc1 = sc + 1
    hit_goal = forward & (ft == GOAL)
    terminated = hit_goal | (forward & (ft == LAVA))
    frac = sc1.to(reward_dtype) / torch.full_like(sc1, max_steps, dtype=reward_dtype)
    reward = torch.where(hit_goal, 1.0 - 0.9 * frac, torch.zeros_like(frac)).float()

    empty_hands = ct == 0
    do_pickup = pickup & ((ft == KEY) | (ft == BALL) | (ft == BOX)) & empty_hands
    do_drop = drop & (ft == EMPTY) & ~empty_hands
    zero = torch.zeros_like(ct)
    carried = [torch.where(do_pickup, f, torch.where(do_drop, zero, c))
               for f, c in ((ft, ct), (fc, cc), (fct, cct), (fcc, ccc))]
    has_key = (ct == KEY) & (cc == fc)
    door_state = torch.where(fs == STATE_LOCKED, torch.where(has_key, STATE_OPEN, STATE_LOCKED).int(), 1 - fs)
    new_fwd = torch.where(do_pickup, EMPTY, fwd)
    new_fwd = torch.where(do_drop, ct | (cc << 4) | (cct << 12) | (ccc << 16), new_fwd)
    new_fwd = torch.where(toggle & (ft == DOOR), (fwd & ~(15 << 8)) | (door_state << 8), new_fwd)
    new_fwd = torch.where(toggle & (ft == BOX), torch.where(fct > 0, fct, EMPTY) | (fcc << 4), new_fwd)
    row = _sel4(d, [torch.full_like(d, o) for o in off_fwd])
    words1 = torch.where(torch.arange(hw, device=dev)[:, None] == row, new_fwd, words)
    moved = words1
    for i, o in enumerate(off_fwd):
        moved = torch.where(moves & (d == i), _roll_rows(words1, o), moved)

    done = terminated | (sc1 >= max_steps)
    words2 = torch.where(done, tmpl_words, moved)
    live = [x1, y1, d1, *carried]
    head = [torch.where(done, tmpl_regs[r : r + 1], v) for r, v in enumerate(live)]
    regs2 = torch.cat(head + [torch.where(done, zero, sc1), torch.where(done, tmpl_regs[R_AUX:], regs[R_AUX:])])
    return words2, regs2, reward, done, observe(words2, regs2, width, height, view, see_through_walls)
