"""ASCII state rendering (counterpart of `minigrid_tpu/utils/ascii.py`):
one lane of a batch of states.

Reference: `MiniGridEnv.__str__` (minigrid.py:~775-830) — two characters
per cell: object letter + color letter, doors shown by state
(`__` open, `D` closed, `L` locked), agent as `>>/VV/<</^^` by heading.
"""

from __future__ import annotations

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import EnvState

# Map of object types to short string (reference __str__ table).
OBJECT_TO_STR = {
    "wall": "W",
    "floor": "F",
    "door": "D",
    "key": "K",
    "ball": "A",
    "box": "B",
    "goal": "G",
    "lava": "V",
}

AGENT_DIR_TO_STR = {0: ">", 1: "V", 2: "<", 3: "^"}


def render_ascii(state: EnvState, lane: int = 0) -> str:
    """Lane `lane` of a batch of states as text, one line per grid row."""
    grid = state.grid[lane].cpu().numpy()
    ax, ay = state.agent_pos[lane].cpu().numpy()
    agent_dir = int(state.agent_dir[lane])

    rows = []
    for y in range(grid.shape[0]):
        row = ""
        for x in range(grid.shape[1]):
            if x == ax and y == ay:
                row += 2 * AGENT_DIR_TO_STR[agent_dir]
                continue
            t, c, s = grid[y, x, 0], grid[y, x, 1], grid[y, x, 2]
            name = C.IDX_TO_OBJECT.get(int(t), "?")
            if name in ("empty", "unseen"):
                row += "  "
                continue
            color_letter = C.IDX_TO_COLOR.get(int(c), "?")[0].upper()
            if name == "door":
                if s == C.STATE_OPEN:
                    row += "__"
                elif s == C.STATE_LOCKED:
                    row += "L" + color_letter
                else:
                    row += "D" + color_letter
                continue
            row += OBJECT_TO_STR.get(name, "?") + color_letter
        rows.append(row)
    return "\n".join(rows)
