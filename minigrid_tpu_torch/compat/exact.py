"""Bit-exact host-side layout replayer (counterpart of
`minigrid_tpu/compat/exact.py`).

The batched generators (`minigrid_tpu_torch.envs.*`) are distribution-exact but
draw from counter-based PRNG keys, so their layouts cannot match the
reference byte-for-byte. This module replays the reference's *exact*
MT19937 call sequence per environment family (SURVEY.md §2.6 "gen calls"),
producing `EnvState` arrays identical to what the reference's `_gen_grid`
would build under the same seed — the substrate for golden-trajectory
equivalence tests (BASELINE.md north star).

Stepping a compat-generated state through the port's `Env.step` is then
bit-exact for every deterministic-transition env; the one stochastic-
transition family, DynamicObstacles, gets trajectory-level exactness via
`walk_obstacles`/`dynobst_step` (host MT19937 obstacle walk continuing the
generator's stream, then the port's deterministic tail,
`envs/dynamicobstacles.py::post_walk_step`, on a batch of one).

The replayer is host NumPy and imports no gymnasium; `state_to_device`
uploads a layout as a batch of one (on the card unless the caller names a
device).
"""

from __future__ import annotations

import numpy as np

from minigrid_tpu_torch.compat.seeding import np_random
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import AUX_LEN, EnvConfig
from minigrid_tpu_torch.envs.registry import registry

EMPTY_CELL = np.array([C.EMPTY, 0, 0, 0, 0], np.uint8)
WALL_CELL = np.array([C.WALL, C.GREY, 0, 0, 0], np.uint8)


def _cell(t, c=0, s=0, ct=0, cc=0):
    return np.array([t, c, s, ct, cc], np.uint8)


class CompatEnv:
    """Stateful exact replayer for one env id.

    Usage:
        cenv = CompatEnv("MiniGrid-DoorKey-8x8-v0", seed=1337)
        state = cenv.reset()        # numpy EnvState dict, exact layout
        state = cenv.reset()        # continues the same MT19937 stream
    """

    def __init__(self, env_id: str, seed: int = 1337):
        self.env_id = env_id
        self.spec = registry[env_id]
        self.config: EnvConfig = self.spec.config
        self.seed(seed)

    # ----------------------------------------------------- RNG veneers
    # (minigrid.py:~842-895 — exact call order is the whole point)
    def seed(self, seed: int):
        self.np_random, _ = np_random(seed)

    def _rand_int(self, low, high):
        return int(self.np_random.randint(low, high))

    def _rand_bool(self):
        return bool(self.np_random.randint(0, 2) == 0)

    def _rand_elem(self, iterable):
        lst = list(iterable)
        return lst[self._rand_int(0, len(lst))]

    def _rand_subset(self, iterable, num_elems):
        lst = list(iterable)
        out = []
        while len(out) < num_elems:
            elem = self._rand_elem(lst)
            lst.remove(elem)
            out.append(elem)
        return out

    def _rand_color(self):
        return self._rand_elem(C.COLOR_NAMES)

    # ------------------------------------------------------ grid helpers
    def _new_grid(self, w=None, h=None):
        w = w or self.config.width
        h = h or self.config.height
        g = np.zeros((h, w, 5), np.uint8)
        g[:, :] = EMPTY_CELL
        return g

    def horz_wall(self, x, y, length=None):
        length = self.grid.shape[1] - x if length is None else length
        self.grid[y, x : x + length] = WALL_CELL

    def vert_wall(self, x, y, length=None):
        length = self.grid.shape[0] - y if length is None else length
        self.grid[y : y + length, x] = WALL_CELL

    def wall_rect(self, x, y, w, h):
        self.horz_wall(x, y, w)
        self.horz_wall(x, y + h - 1, w)
        self.vert_wall(x, y, h)
        self.vert_wall(x + w - 1, y, h)

    def put_obj(self, cell, i, j):
        self.grid[j, i] = cell

    def place_obj(self, cell, top=None, size=None, reject_fn=None, max_tries=np.inf):
        """Exact rejection-sampling loop (minigrid.py:~897-945)."""
        if top is None:
            top = (0, 0)
        else:
            top = (max(top[0], 0), max(top[1], 0))
        if size is None:
            size = (self.grid.shape[1], self.grid.shape[0])
        num_tries = 0
        while True:
            if num_tries > max_tries:
                raise RecursionError("rejection sampling failed in place_obj")
            num_tries += 1
            pos = np.array(
                (
                    self._rand_int(top[0], min(top[0] + size[0], self.grid.shape[1])),
                    self._rand_int(top[1], min(top[1] + size[1], self.grid.shape[0])),
                )
            )
            if self.grid[pos[1], pos[0], 0] != C.EMPTY:
                continue
            if self.agent_pos is not None and np.array_equal(pos, self.agent_pos):
                continue
            if reject_fn and reject_fn(self, pos):
                continue
            break
        if cell is not None:
            self.grid[pos[1], pos[0]] = cell
        return pos

    def place_agent(self, top=None, size=None, rand_dir=True, max_tries=np.inf):
        self.agent_pos = None
        pos = self.place_obj(None, top, size, max_tries=max_tries)
        self.agent_pos = pos
        if rand_dir:
            self.agent_dir = self._rand_int(0, 4)
        return pos

    # ---------------------------------------------------------------- reset
    def reset(self) -> dict:
        """Generate the next layout, continuing the MT19937 stream
        (reference reset() semantics: no reseed)."""
        self.grid = self._new_grid()
        self.agent_pos = None
        self.agent_dir = None
        self.mission = ""
        self.aux = np.zeros(AUX_LEN, np.int64)
        gen = getattr(self, "_gen_" + self.config.family, None)
        if gen is None:
            raise NotImplementedError(f"no exact replay for family {self.config.family!r}")
        gen()
        assert self.agent_pos is not None and self.agent_dir is not None
        return dict(
            grid=self.grid.copy(),
            agent_pos=np.asarray(self.agent_pos, np.int32),
            agent_dir=np.int32(self.agent_dir),
            carrying=np.zeros(4, np.uint8),
            step_count=np.int32(0),
            mission=self.mission,
            aux=self.aux.copy(),
        )

    # ------------------------------------------------------------- families
    def _gen_empty(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        self.put_obj(_cell(C.GOAL, C.GREEN), w - 2, h - 2)
        if cfg.agent_start_pos is not None:
            self.agent_pos = np.asarray(cfg.agent_start_pos)
            self.agent_dir = cfg.agent_start_dir or 0
        else:
            self.place_agent()
        self.mission = "get to the green goal square"

    def _gen_distshift(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        self.put_obj(_cell(C.GOAL, C.GREEN), w - 2, 1)
        for i in range(w - 6):
            self.grid[1, 3 + i] = _cell(C.LAVA, C.RED)
            self.grid[cfg.strip2_row, 3 + i] = _cell(C.LAVA, C.RED)
        self.agent_pos = np.asarray(cfg.agent_start_pos)
        self.agent_dir = cfg.agent_start_dir
        self.mission = "get to the green goal square"

    def _gen_lavagap(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        self.agent_pos = np.array((1, 1))
        self.agent_dir = 0
        self.put_obj(_cell(C.GOAL, C.GREEN), w - 2, h - 2)
        gap_x = self._rand_int(2, w - 2)
        gap_y = self._rand_int(1, h - 1)
        for j in range(1, h - 1):
            self.grid[j, gap_x] = _cell(C.LAVA, C.RED)
        self.grid[gap_y, gap_x] = EMPTY_CELL
        self.mission = "avoid the lava and get to the green goal square"

    def _gen_fourrooms(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        room_w, room_h = w // 2, h // 2
        for j in range(2):
            for i in range(2):
                x_l, y_t = i * room_w, j * room_h
                x_r, y_b = x_l + room_w, y_t + room_h
                if i + 1 < 2:
                    self.vert_wall(x_r, y_t, room_h)
                    pos = (x_r, self._rand_int(y_t + 1, y_b))
                    self.grid[pos[1], pos[0]] = EMPTY_CELL
                if j + 1 < 2:
                    self.horz_wall(x_l, y_b, room_w)
                    pos = (self._rand_int(x_l + 1, x_r), y_b)
                    self.grid[pos[1], pos[0]] = EMPTY_CELL
        self.place_agent()
        self.place_obj(_cell(C.GOAL, C.GREEN))
        self.mission = "Reach the goal"

    def _gen_doorkey(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        self.put_obj(_cell(C.GOAL, C.GREEN), w - 2, h - 2)
        split_idx = self._rand_int(2, w - 2)
        self.vert_wall(split_idx, 0)
        self.place_agent(size=(split_idx, h))
        door_idx = self._rand_int(1, w - 2)
        self.put_obj(_cell(C.DOOR, C.YELLOW, C.STATE_LOCKED), split_idx, door_idx)
        self.place_obj(_cell(C.KEY, C.YELLOW), top=(0, 0), size=(split_idx, h))
        self.mission = "use the key to open the door and then get to the goal"

    def _gen_crossing(self):
        import itertools as itt

        cfg = self.config
        size = cfg.width
        self.wall_rect(0, 0, size, size)
        self.agent_pos = np.array((1, 1))
        self.agent_dir = 0
        self.put_obj(_cell(C.GOAL, C.GREEN), size - 2, size - 2)
        obst = (
            _cell(C.WALL, C.GREY)
            if cfg.obstacle_type == "wall"
            else _cell(C.LAVA, C.RED)
        )

        v, hh = object(), object()
        rivers = [(v, i) for i in range(2, size - 2, 2)]
        rivers += [(hh, j) for j in range(2, size - 2, 2)]
        self.np_random.shuffle(rivers)
        rivers = rivers[: cfg.num_crossings]
        rivers_v = sorted(pos for d, pos in rivers if d is v)
        rivers_h = sorted(pos for d, pos in rivers if d is hh)
        obstacle_pos = itt.chain(
            itt.product(range(1, size - 1), rivers_h),
            itt.product(rivers_v, range(1, size - 1)),
        )
        for i, j in obstacle_pos:
            self.put_obj(obst, i, j)

        path = [hh] * len(rivers_v) + [v] * len(rivers_h)
        self.np_random.shuffle(path)
        limits_v = [0] + rivers_v + [size - 1]
        limits_h = [0] + rivers_h + [size - 1]
        room_i, room_j = 0, 0
        for direction in path:
            if direction is hh:
                i = limits_v[room_i + 1]
                j = self.np_random.choice(
                    range(limits_h[room_j] + 1, limits_h[room_j + 1])
                )
                room_i += 1
            else:
                i = self.np_random.choice(
                    range(limits_v[room_i] + 1, limits_v[room_i + 1])
                )
                j = limits_h[room_j + 1]
                room_j += 1
            self.grid[j, i] = EMPTY_CELL
        self.mission = (
            "find the opening and get to the green goal square"
            if cfg.obstacle_type == "wall"
            else "avoid the lava and get to the green goal square"
        )

    def _gen_dynamicobstacles(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        self.put_obj(_cell(C.GOAL, C.GREEN), w - 2, h - 2)
        if cfg.agent_start_pos is not None:
            self.agent_pos = np.asarray(cfg.agent_start_pos)
            self.agent_dir = cfg.agent_start_dir or 0
        else:
            self.place_agent()
        self.mission = "get to the green goal square"
        for i in range(cfg.n_obstacles):
            pos = self.place_obj(_cell(C.BALL, C.BLUE), max_tries=100)
            self.aux[2 * i] = pos[0]
            self.aux[2 * i + 1] = pos[1]

    def walk_obstacles(self):
        """The reference DynamicObstaclesEnv.step's obstacle walk
        (dynamicobstacles.py:~70-85), continuing the same MT19937 stream
        `_gen_grid` drew from: sequentially per obstacle,
        `place_obj(ball, top=old-(1,1), size=(3,3), max_tries=100)` —
        the obstacle's own old cell is still occupied so it always moves
        when any free cell exists — then clear the old cell; an exhausted
        rejection loop (boxed in, 101 draw pairs consumed) leaves the
        obstacle in place (the reference's `except: pass`). Set
        `self.agent_pos` to the LIVE agent position first (the rejection
        loop must skip it)."""
        for i in range(self.config.n_obstacles):
            ox, oy = int(self.aux[2 * i]), int(self.aux[2 * i + 1])
            try:
                pos = self.place_obj(
                    _cell(C.BALL, C.BLUE), top=(ox - 1, oy - 1),
                    size=(3, 3), max_tries=100,
                )
            except RecursionError:
                continue
            self.grid[oy, ox] = EMPTY_CELL
            self.aux[2 * i] = int(pos[0])
            self.aux[2 * i + 1] = int(pos[1])

    def _gen_memory(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        assert h % 2 == 1
        self.wall_rect(0, 0, w, h)
        upper = h // 2 - 2
        lower = h // 2 + 2
        mid = h // 2
        hallway_end = self._rand_int(4, w - 2) if cfg.random_length else w - 3
        for i in range(1, 5):
            self.grid[upper, i] = WALL_CELL
            self.grid[lower, i] = WALL_CELL
        self.grid[upper + 1, 4] = WALL_CELL
        self.grid[lower - 1, 4] = WALL_CELL
        for i in range(5, hallway_end):
            self.grid[upper + 1, i] = WALL_CELL
            self.grid[lower - 1, i] = WALL_CELL
        for j in range(h):
            if j != mid:
                self.grid[j, hallway_end] = WALL_CELL
        self.agent_pos = np.array((self._rand_int(1, hallway_end + 1), mid))
        self.agent_dir = 0
        start_obj = self._rand_elem([C.KEY, C.BALL])
        self.grid[mid - 1, 1] = _cell(start_obj, C.GREEN)
        other_objs = self._rand_elem([[C.BALL, C.KEY], [C.KEY, C.BALL]])
        pos0 = (hallway_end + 1, mid - 2)
        pos1 = (hallway_end + 1, mid + 2)
        self.grid[pos0[1], pos0[0]] = _cell(other_objs[0], C.GREEN)
        self.grid[pos1[1], pos1[0]] = _cell(other_objs[1], C.GREEN)
        if start_obj == other_objs[0]:
            success, failure = (pos0[0], pos0[1] + 1), (pos1[0], pos1[1] - 1)
        else:
            success, failure = (pos1[0], pos1[1] - 1), (pos0[0], pos0[1] + 1)
        self.aux[0:2] = success
        self.aux[2:4] = failure
        self.mission = "go to the matching object at the end of the hallway"

    def _gen_redbluedoors(self):
        size = self.config.height
        self.wall_rect(0, 0, 2 * size, size)
        self.wall_rect(size // 2, 0, size, size)
        self.place_agent(top=(size // 2, 0), size=(size, size))
        red_pos = (size // 2, self._rand_int(1, size - 1))
        self.grid[red_pos[1], red_pos[0]] = _cell(C.DOOR, C.RED, C.STATE_CLOSED)
        blue_pos = (size // 2 + size - 1, self._rand_int(1, size - 1))
        self.grid[blue_pos[1], blue_pos[0]] = _cell(C.DOOR, C.BLUE, C.STATE_CLOSED)
        self.aux[0:2] = red_pos
        self.aux[2:4] = blue_pos
        self.mission = "open the red door then the blue door"

    def _gen_fetch(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.horz_wall(0, 0)
        self.horz_wall(0, h - 1)
        self.vert_wall(0, 0)
        self.vert_wall(w - 1, 0)
        types = ["key", "ball"]
        objs = []
        while len(objs) < cfg.num_objs:
            obj_type = self._rand_elem(types)
            obj_color = self._rand_color()
            t = C.KEY if obj_type == "key" else C.BALL
            self.place_obj(_cell(t, C.COLOR_TO_IDX[obj_color]))
            objs.append((obj_type, obj_color))
        self.place_agent()
        target = objs[self._rand_int(0, len(objs))]
        self.aux[0] = C.KEY if target[0] == "key" else C.BALL
        self.aux[1] = C.COLOR_TO_IDX[target[1]]
        desc = f"{target[1]} {target[0]}"
        idx = self._rand_int(0, 5)
        self.mission = [
            "get a %s" % desc,
            "go get a %s" % desc,
            "fetch a %s" % desc,
            "go fetch a %s" % desc,
            "you must fetch a %s" % desc,
        ][idx]

    def _gen_gotodoor(self):
        cfg = self.config
        w = self._rand_int(5, cfg.width + 1)
        h = self._rand_int(5, cfg.height + 1)
        self.wall_rect(0, 0, w, h)
        door_pos = [
            (self._rand_int(2, w - 2), 0),
            (self._rand_int(2, w - 2), h - 1),
            (0, self._rand_int(2, h - 2)),
            (w - 1, self._rand_int(2, h - 2)),
        ]
        door_colors = []
        while len(door_colors) < len(door_pos):
            color = self._rand_color()
            if color in door_colors:
                continue
            door_colors.append(color)
        for idx, pos in enumerate(door_pos):
            self.grid[pos[1], pos[0]] = _cell(
                C.DOOR, C.COLOR_TO_IDX[door_colors[idx]], C.STATE_CLOSED
            )
        self.place_agent(size=(w, h))
        door_idx = self._rand_int(0, len(door_pos))
        self.aux[0:2] = door_pos[door_idx]
        self.aux[2] = C.COLOR_TO_IDX[door_colors[door_idx]]
        self.mission = "go to the %s door" % door_colors[door_idx]

    def _gen_gotoobject(self):
        cfg = self.config
        self.wall_rect(0, 0, cfg.width, cfg.height)
        types = ["key", "ball", "box"]
        objs, obj_pos = [], []
        while len(objs) < cfg.num_objs:
            obj_type = self._rand_elem(types)
            obj_color = self._rand_color()
            if (obj_type, obj_color) in objs:
                continue
            t = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[obj_type]
            pos = self.place_obj(_cell(t, C.COLOR_TO_IDX[obj_color]))
            objs.append((obj_type, obj_color))
            obj_pos.append(pos)
        self.place_agent()
        idx = self._rand_int(0, len(objs))
        self.aux[0:2] = obj_pos[idx]
        self.aux[2] = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[objs[idx][0]]
        self.aux[3] = C.COLOR_TO_IDX[objs[idx][1]]
        self.mission = "go to the %s %s" % (objs[idx][1], objs[idx][0])

    def _gen_putnear(self):
        cfg = self.config
        self.wall_rect(0, 0, cfg.width, cfg.height)
        types = ["key", "ball", "box"]
        objs, obj_pos = [], []

        def near_obj(env, p1):
            for p2 in obj_pos:
                dx, dy = p1[0] - p2[0], p1[1] - p2[1]
                if abs(dx) <= 1 and abs(dy) <= 1:
                    return True
            return False

        while len(objs) < cfg.num_objs:
            obj_type = self._rand_elem(types)
            obj_color = self._rand_color()
            if (obj_type, obj_color) in objs:
                continue
            t = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[obj_type]
            pos = self.place_obj(_cell(t, C.COLOR_TO_IDX[obj_color]), reject_fn=near_obj)
            objs.append((obj_type, obj_color))
            obj_pos.append(pos)
        self.place_agent()
        idx = self._rand_int(0, len(objs))
        move_type, move_color = objs[idx]
        while True:
            target_idx = self._rand_int(0, len(objs))
            if target_idx != idx:
                break
        target_type, target_color = objs[target_idx]
        self.aux[0] = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[move_type]
        self.aux[1] = C.COLOR_TO_IDX[move_color]
        self.aux[2:4] = obj_pos[target_idx]
        self.aux[4] = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[target_type]
        self.aux[5] = C.COLOR_TO_IDX[target_color]
        self.mission = "put the %s %s near the %s %s" % (
            move_color, move_type, target_color, target_type,
        )

    def _gen_lockedroom(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        for i in range(w):
            self.grid[0, i] = WALL_CELL
            self.grid[h - 1, i] = WALL_CELL
        for j in range(h):
            self.grid[j, 0] = WALL_CELL
            self.grid[j, w - 1] = WALL_CELL
        l_wall = w // 2 - 2
        r_wall = w // 2 + 2
        for j in range(h):
            self.grid[j, l_wall] = WALL_CELL
            self.grid[j, r_wall] = WALL_CELL
        rooms = []
        room_w, room_h = l_wall + 1, h // 3 + 1
        for n in range(3):
            j = n * (h // 3)
            for i in range(l_wall):
                self.grid[j, i] = WALL_CELL
            for i in range(r_wall, w):
                self.grid[j, i] = WALL_CELL
            rooms.append(dict(top=(0, j), size=(room_w, room_h), door=(l_wall, j + 3)))
            rooms.append(
                dict(top=(r_wall, j), size=(room_w, room_h), door=(r_wall, j + 3))
            )
        locked = self._rand_elem(rooms)
        locked["locked"] = True
        gx = self._rand_int(locked["top"][0] + 1, locked["top"][0] + locked["size"][0] - 1)
        gy = self._rand_int(locked["top"][1] + 1, locked["top"][1] + locked["size"][1] - 1)
        self.grid[gy, gx] = _cell(C.GOAL, C.GREEN)
        colors = set(C.COLOR_NAMES)
        for room in rooms:
            color = self._rand_elem(sorted(colors))
            colors.remove(color)
            room["color"] = color
            state = C.STATE_LOCKED if room.get("locked") else C.STATE_CLOSED
            self.grid[room["door"][1], room["door"][0]] = _cell(
                C.DOOR, C.COLOR_TO_IDX[color], state
            )
        while True:
            key_room = self._rand_elem(rooms)
            if key_room is not locked:
                break
        kx = self._rand_int(
            key_room["top"][0] + 1, key_room["top"][0] + key_room["size"][0] - 1
        )
        ky = self._rand_int(
            key_room["top"][1] + 1, key_room["top"][1] + key_room["size"][1] - 1
        )
        self.grid[ky, kx] = _cell(C.KEY, C.COLOR_TO_IDX[locked["color"]])
        self.place_agent(top=(l_wall, 0), size=(r_wall - l_wall, h))
        self.mission = (
            "get the %s key from the %s room, unlock the %s door and go to the goal"
            % (locked["color"], key_room["color"], locked["color"])
        )

    def _gen_playground(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        self.wall_rect(0, 0, w, h)
        room_w, room_h = w // 3, h // 3
        for j in range(3):
            for i in range(3):
                x_l, y_t = i * room_w, j * room_h
                x_r, y_b = x_l + room_w, y_t + room_h
                if i + 1 < 3:
                    self.vert_wall(x_r, y_t, room_h)
                    pos = (x_r, self._rand_int(y_t + 1, y_b - 1))
                    color = self._rand_color()
                    self.grid[pos[1], pos[0]] = _cell(
                        C.DOOR, C.COLOR_TO_IDX[color], C.STATE_CLOSED
                    )
                if j + 1 < 3:
                    self.horz_wall(x_l, y_b, room_w)
                    pos = (self._rand_int(x_l + 1, x_r - 1), y_b)
                    color = self._rand_color()
                    self.grid[pos[1], pos[0]] = _cell(
                        C.DOOR, C.COLOR_TO_IDX[color], C.STATE_CLOSED
                    )
        types = ["key", "ball", "box"]
        for _ in range(12):
            obj_type = self._rand_elem(types)
            obj_color = self._rand_color()
            t = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[obj_type]
            self.place_obj(_cell(t, C.COLOR_TO_IDX[obj_color]))
        self.place_agent()
        self.mission = ""

    def _gen_multiroom(self):
        cfg = self.config
        w, h = cfg.width, cfg.height
        num_rooms = self._rand_int(cfg.min_num_rooms, cfg.max_num_rooms + 1)
        room_list = []
        while len(room_list) < num_rooms:
            cur_list = []
            entry = (self._rand_int(0, w - 2), self._rand_int(0, w - 2))
            self._place_room(
                num_rooms, cur_list, 4, cfg.max_room_size, 2, entry, w, h
            )
            if len(cur_list) > len(room_list):
                room_list = cur_list
        self.grid = self._new_grid()
        prev_color = None
        for idx, room in enumerate(room_list):
            tx, ty = room["top"]
            sx, sy = room["size"]
            for i in range(sx):
                self.grid[ty, tx + i] = WALL_CELL
                self.grid[ty + sy - 1, tx + i] = WALL_CELL
            for j in range(sy):
                self.grid[ty + j, tx] = WALL_CELL
                self.grid[ty + j, tx + sx - 1] = WALL_CELL
            if idx > 0:
                colors = set(C.COLOR_NAMES)
                if prev_color:
                    colors.remove(prev_color)
                color = self._rand_elem(sorted(colors))
                ex, ey = room["entry"]
                self.grid[ey, ex] = _cell(C.DOOR, C.COLOR_TO_IDX[color], C.STATE_CLOSED)
                prev_color = color
        self.place_agent(room_list[0]["top"], room_list[0]["size"])
        self.place_obj(
            _cell(C.GOAL, C.GREEN), room_list[-1]["top"], room_list[-1]["size"]
        )
        self.mission = "traverse the rooms to get to the goal"

    def _place_room(self, num_left, room_list, min_sz, max_sz, entry_wall, entry_pos, w, h):
        sx = self._rand_int(min_sz, max_sz + 1)
        sy = self._rand_int(min_sz, max_sz + 1)
        if len(room_list) == 0:
            tx, ty = entry_pos
        elif entry_wall == 0:
            tx = entry_pos[0] - sx + 1
            ty = self._rand_int(entry_pos[1] - sy + 2, entry_pos[1])
        elif entry_wall == 1:
            tx = self._rand_int(entry_pos[0] - sx + 2, entry_pos[0])
            ty = entry_pos[1] - sy + 1
        elif entry_wall == 2:
            tx = entry_pos[0]
            ty = self._rand_int(entry_pos[1] - sy + 2, entry_pos[1])
        else:
            tx = self._rand_int(entry_pos[0] - sx + 2, entry_pos[0])
            ty = entry_pos[1]
        if tx < 0 or ty < 0:
            return False
        if tx + sx > w or ty + sy >= h:
            return False
        for room in room_list[:-1]:
            ox, oy = room["top"]
            osx, osy = room["size"]
            non_overlap = (
                tx + sx < ox or ox + osx <= tx or ty + sy < oy or oy + osy <= ty
            )
            if not non_overlap:
                return False
        room_list.append(dict(top=(tx, ty), size=(sx, sy), entry=entry_pos))
        if num_left == 1:
            return True
        for _ in range(8):
            wall_set = {0, 1, 2, 3}
            wall_set.remove(entry_wall)
            exit_wall = self._rand_elem(sorted(wall_set))
            next_entry_wall = (exit_wall + 2) % 4
            if exit_wall == 0:
                exit_pos = (tx + sx - 1, ty + self._rand_int(1, sy - 1))
            elif exit_wall == 1:
                exit_pos = (tx + self._rand_int(1, sx - 1), ty + sy - 1)
            elif exit_wall == 2:
                exit_pos = (tx, ty + self._rand_int(1, sy - 1))
            else:
                exit_pos = (tx + self._rand_int(1, sx - 1), ty)
            if self._place_room(
                num_left - 1, room_list, min_sz, max_sz, next_entry_wall, exit_pos, w, h
            ):
                break
        return True


    # ----------------------------------------------- RoomGrid machinery
    # Exact call-order replay of gym_minigrid/roomgrid.py (~400 LoC).

    def _roomgrid_init(self):
        cfg = self.config
        rs, rows, cols = cfg.room_size, cfg.num_rows, cfg.num_cols
        self.rooms = [[None] * cols for _ in range(rows)]
        for j in range(rows):
            for i in range(cols):
                top = (i * (rs - 1), j * (rs - 1))
                self.rooms[j][i] = dict(
                    top=top, size=(rs, rs),
                    door_pos=[None] * 4, doors=[None] * 4, locked=False,
                )
                self.wall_rect(top[0], top[1], rs, rs)
        # Door-position draws: row-major, right then down per room.
        for j in range(rows):
            for i in range(cols):
                room = self.rooms[j][i]
                x_l, y_t = room["top"][0] + 1, room["top"][1] + 1
                x_m = room["top"][0] + rs - 1
                y_m = room["top"][1] + rs - 1
                if i < cols - 1:
                    room["door_pos"][0] = (x_m, self._rand_int(y_t, y_m))
                if j < rows - 1:
                    room["door_pos"][1] = (self._rand_int(x_l, x_m), y_m)
                if i > 0:
                    room["door_pos"][2] = self.rooms[j][i - 1]["door_pos"][0]
                if j > 0:
                    room["door_pos"][3] = self.rooms[j - 1][i]["door_pos"][1]
        self.agent_pos = np.array(
            ((cols // 2) * (rs - 1) + rs // 2, (rows // 2) * (rs - 1) + rs // 2)
        )
        self.agent_dir = 0

    def _rg_neighbor(self, i, j, k):
        di, dj = C.DIR_TO_VEC[k]
        ni, nj = i + di, j + dj
        if 0 <= ni < self.config.num_cols and 0 <= nj < self.config.num_rows:
            return ni, nj
        return None

    def _rg_add_door(self, i, j, door_idx=None, color=None, locked=None):
        room = self.rooms[j][i]
        if door_idx is None:
            while True:
                door_idx = self._rand_int(0, 4)
                if self._rg_neighbor(i, j, door_idx):
                    break
        if color is None:
            color = self._rand_color()
        if locked is None:
            locked = self._rand_bool()
        room["locked"] = locked
        pos = room["door_pos"][door_idx]
        state = C.STATE_LOCKED if locked else C.STATE_CLOSED
        self.grid[pos[1], pos[0]] = _cell(C.DOOR, C.COLOR_TO_IDX[color], state)
        room["doors"][door_idx] = color
        ni, nj = self._rg_neighbor(i, j, door_idx)
        self.rooms[nj][ni]["doors"][(door_idx + 2) % 4] = color
        return color, pos

    def _rg_remove_wall(self, i, j, wall_idx):
        room = self.rooms[j][i]
        tx, ty = room["top"]
        w, h = room["size"]
        if wall_idx == 0:
            for k in range(1, h - 1):
                self.grid[ty + k, tx + w - 1] = EMPTY_CELL
        elif wall_idx == 1:
            for k in range(1, w - 1):
                self.grid[ty + h - 1, tx + k] = EMPTY_CELL
        elif wall_idx == 2:
            for k in range(1, h - 1):
                self.grid[ty + k, tx] = EMPTY_CELL
        else:
            for k in range(1, w - 1):
                self.grid[ty, tx + k] = EMPTY_CELL
        room["doors"][wall_idx] = "__removed__"
        ni, nj = self._rg_neighbor(i, j, wall_idx)
        self.rooms[nj][ni]["doors"][(wall_idx + 2) % 4] = "__removed__"

    def _rg_place_in_room(self, i, j, cell):
        room = self.rooms[j][i]

        def reject_next_to(env, pos):
            sx, sy = env.agent_pos
            return abs(sx - pos[0]) + abs(sy - pos[1]) < 2

        return self.place_obj(
            cell, room["top"], room["size"], reject_fn=reject_next_to,
            max_tries=1000,
        )

    def _rg_add_object(self, i, j, kind=None, color=None):
        if kind is None:
            kind = self._rand_elem(["key", "ball", "box"])
        if color is None:
            color = self._rand_color()
        t = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}[kind]
        pos = self._rg_place_in_room(i, j, _cell(t, C.COLOR_TO_IDX[color]))
        return (kind, color), pos

    def _rg_place_agent(self, i, j, rand_dir=True):
        room = self.rooms[j][i]
        while True:
            self.place_agent(room["top"], room["size"], rand_dir, max_tries=1000)
            fx = self.agent_pos[0] + C.DIR_TO_VEC[self.agent_dir][0]
            fy = self.agent_pos[1] + C.DIR_TO_VEC[self.agent_dir][1]
            ft = self.grid[fy, fx, 0]
            if ft in (C.EMPTY, C.WALL):
                break

    def _rg_reachable(self):
        start = (
            min(int(self.agent_pos[0]) // (self.config.room_size - 1),
                self.config.num_cols - 1),
            min(int(self.agent_pos[1]) // (self.config.room_size - 1),
                self.config.num_rows - 1),
        )
        reach, stack = set(), [start]
        while stack:
            (i, j) = stack.pop()
            if (i, j) in reach:
                continue
            reach.add((i, j))
            for k in range(4):
                if self.rooms[j][i]["doors"][k]:
                    stack.append(self._rg_neighbor(i, j, k))
        return reach

    def _rg_connect_all(self, door_colors=C.COLOR_NAMES, max_itrs=5000):
        for n in range(max_itrs):
            if len(self._rg_reachable()) == (
                self.config.num_rows * self.config.num_cols
            ):
                return
            i = self._rand_int(0, self.config.num_cols)
            j = self._rand_int(0, self.config.num_rows)
            k = self._rand_int(0, 4)
            room = self.rooms[j][i]
            if not room["door_pos"][k] or room["doors"][k]:
                continue
            ni, nj = self._rg_neighbor(i, j, k) or (None, None)
            if ni is None:
                continue
            if room["locked"] or self.rooms[nj][ni]["locked"]:
                continue
            color = self._rand_elem(door_colors)
            self._rg_add_door(i, j, k, color, False)
        raise RecursionError("connect_all failed")

    # ------------------------------------------------- RoomGrid families
    def _gen_unlock(self):
        self._roomgrid_init()
        color, pos = self._rg_add_door(0, 0, 0, locked=True)
        self._rg_add_object(0, 0, "key", color)
        self._rg_place_agent(0, 0)
        self.aux[0:2] = pos
        self.mission = "open the door"

    def _gen_unlockpickup(self, blocked=False):
        self._roomgrid_init()
        (kind, ocolor), _ = self._rg_add_object(1, 0, kind="box")
        color, pos = self._rg_add_door(0, 0, 0, locked=True)
        if blocked:
            bcolor = self._rand_color()
            self.grid[pos[1], pos[0] - 1] = _cell(C.BALL, C.COLOR_TO_IDX[bcolor])
        self._rg_add_object(0, 0, "key", color)
        self._rg_place_agent(0, 0)
        self.aux[0] = C.BOX
        self.aux[1] = C.COLOR_TO_IDX[ocolor]
        self.mission = "pick up the %s %s" % (ocolor, kind)

    def _gen_blockedunlockpickup(self):
        self._gen_unlockpickup(blocked=True)

    def _gen_keycorridor(self):
        self._roomgrid_init()
        for j in range(1, self.config.num_rows):
            self._rg_remove_wall(1, j, 3)
        room_idx = self._rand_int(0, self.config.num_rows)
        door_color, _ = self._rg_add_door(2, room_idx, 2, locked=True)
        (kind, ocolor), _ = self._rg_add_object(2, room_idx, kind="ball")
        self._rg_add_object(0, self._rand_int(0, self.config.num_rows), "key",
                            door_color)
        self._rg_place_agent(1, self.config.num_rows // 2)
        self._rg_connect_all()
        self.aux[0] = C.BALL
        self.aux[1] = C.COLOR_TO_IDX[ocolor]
        self.mission = "pick up the %s %s" % (ocolor, kind)

    def _gen_obstructedmaze(self):
        self._roomgrid_init()
        door_colors = self._rand_subset(C.COLOR_NAMES, len(C.COLOR_NAMES))
        ball_color = C.COLOR_NAMES[0]
        block_color = C.COLOR_NAMES[1]
        box_color = C.COLOR_NAMES[2]
        extras = self.config.extras

        def om_add_door(i, j, door_idx, color, locked, key_in_box, blocked):
            dcolor, pos = self._rg_add_door(i, j, door_idx, color, locked)
            if blocked:
                vec = C.DIR_TO_VEC[door_idx]
                self.grid[pos[1] - vec[1], pos[0] - vec[0]] = _cell(
                    C.BALL, C.COLOR_TO_IDX[block_color]
                )
            if locked:
                if key_in_box:
                    cell = _cell(
                        C.BOX, C.COLOR_TO_IDX[box_color], 0,
                        C.KEY, C.COLOR_TO_IDX[dcolor],
                    )
                else:
                    cell = _cell(C.KEY, C.COLOR_TO_IDX[dcolor])
                self._rg_place_in_room(i, j, cell)

        if extras[0] == "1D":
            _, key_in_box, blocked = extras
            om_add_door(0, 0, 0, door_colors[0], True, key_in_box, blocked)
            self._rg_add_object(1, 0, "ball", ball_color)
            self._rg_place_agent(0, 0)
        else:
            _, agent_i, agent_j, key_in_box, blocked, num_quarters = extras
            side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][:num_quarters]
            for idx, (si, sj) in enumerate(side_rooms):
                self._rg_add_door(1, 1, idx, door_colors[idx], False)
                for k_off in (-1, 1):
                    om_add_door(
                        si, sj, (idx + k_off) % 4,
                        door_colors[(idx + k_off) % len(door_colors)],
                        True, key_in_box, blocked,
                    )
            corners = [(2, 0), (2, 2), (0, 2), (0, 0)][:num_quarters]
            ball_room = corners[self._rand_int(0, len(corners))]
            self._rg_add_object(ball_room[0], ball_room[1], "ball", ball_color)
            self._rg_place_agent(agent_i, agent_j)
        self.aux[0] = C.BALL
        self.aux[1] = C.COLOR_TO_IDX[ball_color]
        self.mission = "pick up the %s ball" % ball_color


def dynobst_step(ce: "CompatEnv", env, state, action: int):
    """One reference-exact DynamicObstacles transition (MT19937 walk) of a
    batch of one.

    Mirrors the reference's step order (dynamicobstacles.py:~60-101):
    record the front cell's clearance BEFORE the walk, random-walk every
    obstacle in turn through `place_obj(ball, top=pos-(1,1), size=(3,3),
    max_tries=100)` rejection from `ce.np_random` — the SAME MT19937
    stream `_gen_grid` drew from — then run the deterministic base
    transition and the collision penalty
    (`envs/dynamicobstacles.py::post_walk_step`) on `state`'s device.

    `ce` owns the authoritative grid/aux for the walk (the only grid
    mutations in this family ARE the walk's: the Discrete(3) action set
    cannot add or remove objects); `state` is the batch-of-one `EnvState`
    whose agent fields advance. Returns `(state, obs, reward, terminated,
    truncated)`, the `env.step` signature, so a trajectory replay swaps it
    in for the stochastic family.
    """
    import torch

    from minigrid_tpu_torch.envs.dynamicobstacles import post_walk_step

    cfg = env.config
    dev = state.grid.device
    ax, ay = (int(v) for v in state.agent_pos[0].cpu())
    dx, dy = C.DIR_TO_VEC[int(state.agent_dir[0])]
    ft = int(ce.grid[ay + int(dy), ax + int(dx), 0])
    not_clear = ft not in (C.EMPTY, C.GOAL)

    ce.agent_pos = np.array([ax, ay])
    ce.walk_obstacles()

    state = state.replace(
        grid=torch.from_numpy(ce.grid.copy())[None].to(dev),
        aux=torch.from_numpy(ce.aux.astype(np.int32))[None].to(dev),
    )
    action = torch.tensor([int(action)], dtype=torch.int32, device=dev)
    res = post_walk_step(state, action, cfg, torch.tensor([not_clear], device=dev))
    obs = env.observe(res.state, cfg)
    return res.state, obs, res.reward, res.terminated, res.truncated


def state_to_device(compat_state: dict, config: EnvConfig, key=None, device=None):
    """Upload a compat layout of `config`'s size as a batch-of-one
    `EnvState` on `device` (default: the card; a given `key` brings its
    own device). The rng leaf is `key` (default: `key(0)`, the JAX
    package's `PRNGKey(0)`); the mission stays host-side (zeros), as in
    the JAX package."""
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.core.state import MISSION_LEN
    from minigrid_tpu_torch.utils.convert import state_from_numpy

    if compat_state["grid"].shape[:2] != (config.height, config.width):
        raise ValueError(f"a {compat_state['grid'].shape[:2]} layout is not {config.family}'s "
                         f"{(config.height, config.width)}")

    if key is not None:
        device = key.device if device is None else device
        rng = key.reshape(1, 2).cpu().numpy().astype(np.uint32)
    else:
        rng = np.zeros((1, 2), np.uint32)
    device = prng.default_device(device)
    return state_from_numpy(dict(
        grid=compat_state["grid"][None],
        agent_pos=np.asarray(compat_state["agent_pos"], np.int32)[None],
        agent_dir=np.asarray(compat_state["agent_dir"], np.int32)[None],
        carrying=np.asarray(compat_state["carrying"], np.uint8)[None],
        step_count=np.asarray(compat_state["step_count"], np.int32)[None],
        rng=rng,
        mission=np.zeros((1, MISSION_LEN), np.int32),
        aux=np.asarray(compat_state["aux"], np.int32)[None],
    ), device=device)
