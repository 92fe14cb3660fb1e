"""Object, colour and door-state ids (counterpart of
`minigrid_tpu/core/constants.py`).

Plain Python ints, identical to the reference's indices, so packed cell
words and encoded observations are byte-compatible with the JAX package.
"""

from __future__ import annotations

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
