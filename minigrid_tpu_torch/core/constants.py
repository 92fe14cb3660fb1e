"""Object, colour and door-state ids (counterpart of
`minigrid_tpu/core/constants.py`).

Plain Python ints, identical to the reference's indices, so packed cell
words and encoded observations are byte-compatible with the JAX package;
then the name tables and the colour palette, equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

UNSEEN = 0
EMPTY = 1
WALL = 2
FLOOR = 3
DOOR = 4
KEY = 5
BALL = 6
BOX = 7
GOAL = 8
LAVA = 9
AGENT = 10
NUM_OBJECTS = 11

STATE_OPEN = 0
STATE_CLOSED = 1
STATE_LOCKED = 2
NUM_STATES = 3

RED = 0
GREEN = 1
BLUE = 2
PURPLE = 3
YELLOW = 4
GREY = 5
NUM_COLORS = 6

COLOR_TO_IDX = {"red": RED, "green": GREEN, "blue": BLUE, "purple": PURPLE, "yellow": YELLOW, "grey": GREY}
# Generators draw colours from the sorted names (the reference's
# COLOR_NAMES: blue, green, grey, purple, red, yellow).
COLOR_NAMES = sorted(COLOR_TO_IDX)

# Heading id -> (dx, dy): 0=right(+x), 1=down(+y), 2=left, 3=up.
DIR_TO_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))

# The object types the agent may stand on (open doors too, by their state)
# and the ones it may pick up.
OVERLAP_TYPES = (EMPTY, FLOOR, GOAL, LAVA)
PICKUP_TYPES = (KEY, BALL, BOX)

# ---------------------------------------------------------------------------
# Names and colours at the API boundary (the JAX package's tables): the
# renderer's palette, the mission strings, the ASCII view and the gym
# adapter read them; the kernels use the ids above.

# Size (in pixels) of a rendered tile cell.
TILE_PIXELS = 32

COLORS = {
    "red": np.array([255, 0, 0], dtype=np.uint8),
    "green": np.array([0, 255, 0], dtype=np.uint8),
    "blue": np.array([0, 0, 255], dtype=np.uint8),
    "purple": np.array([112, 39, 195], dtype=np.uint8),
    "yellow": np.array([255, 255, 0], dtype=np.uint8),
    "grey": np.array([100, 100, 100], dtype=np.uint8),
}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
# (NUM_COLORS, 3) uint8 palette indexed by colour id.
COLOR_PALETTE = np.stack([COLORS[IDX_TO_COLOR[i]] for i in range(NUM_COLORS)])

OBJECT_TO_IDX = {
    "unseen": UNSEEN,
    "empty": EMPTY,
    "wall": WALL,
    "floor": FLOOR,
    "door": DOOR,
    "key": KEY,
    "ball": BALL,
    "box": BOX,
    "goal": GOAL,
    "lava": LAVA,
    "agent": AGENT,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}

STATE_TO_IDX = {"open": STATE_OPEN, "closed": STATE_CLOSED, "locked": STATE_LOCKED}
IDX_TO_STATE = {v: k for k, v in STATE_TO_IDX.items()}
