"""Mission strings as integer tuples (counterpart of
`minigrid_tpu/envs/missions.py`).

A template's id is its index in the JAX package's table, which assigns
ids in the order in which its families register them. The port registers
only the families it has ported, so it keeps a copy of that whole table
instead of counting its own registrations: an id is then the same
whichever families are ported. `detokenize` gives a vector's string.
"""

from __future__ import annotations

import numpy as np

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import MISSION_LEN

# The JAX package's templates, in its id order (template 0: empty mission).
TEMPLATES = (
    "",
    "get to the green goal square",
    "avoid the lava and get to the green goal square",
    "find the opening and get to the green goal square",
    "Reach the goal",
    "use the key to open the door and then get to the goal",
    "go to the matching object at the end of the hallway",
    "get a {c0} {t1}",
    "go get a {c0} {t1}",
    "fetch a {c0} {t1}",
    "go fetch a {c0} {t1}",
    "you must fetch a {c0} {t1}",
    "go to the {c0} door",
    "go to the {c0} {t1}",
    "put the {c0} {t1} near the {c2} {t3}",
    "open the red door then the blue door",
    "traverse the rooms to get to the goal",
    "get the {c0} key from the {c1} room, unlock the {c2} door and go to the goal",
    "open the door",
    "pick up the {c0} {t1}",
    "pick up the {c0} ball",
)


def register_template(fmt: str) -> int:
    """The id of a mission template (its index in `TEMPLATES`)."""
    if fmt not in TEMPLATES:
        raise ValueError(f"mission template {fmt!r} is not in the JAX package's table")
    return TEMPLATES.index(fmt)


def encode(template_id: int, *slots: int) -> np.ndarray:
    """Build a `(MISSION_LEN,)` int32 mission vector."""
    vec = np.zeros(MISSION_LEN, dtype=np.int32)
    vec[0] = template_id
    for i, s in enumerate(slots):
        vec[1 + i] = s
    return vec


def detokenize(mission) -> str:
    """The reference's mission string of one `(MISSION_LEN,)` mission
    vector (numpy, a list, or a tensor on any device)."""
    if hasattr(mission, "cpu"):
        mission = mission.cpu()
    mission = np.asarray(mission)
    out = TEMPLATES[int(mission[0])]
    for i in range(MISSION_LEN - 1):
        val = int(mission[1 + i])
        out = out.replace("{c%d}" % i, C.IDX_TO_COLOR.get(val, "?"))
        out = out.replace("{t%d}" % i, C.IDX_TO_OBJECT.get(val, "?"))
        out = out.replace("{d%d}" % i, str(val))
    return out
