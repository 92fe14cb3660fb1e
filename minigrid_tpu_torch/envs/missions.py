"""Mission strings as integer tuples (counterpart of
`minigrid_tpu/envs/missions.py`).

Template ids are assigned in registration order, and the family modules
are imported in the JAX package's order (`envs/_register_all.py`), so a
template gets the id the JAX package gives it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from minigrid_tpu_torch.core.state import MISSION_LEN

_TEMPLATES: List[str] = [""]  # template 0: empty mission


def register_template(fmt: str) -> int:
    """Register a mission template and return its id (idempotent)."""
    if fmt in _TEMPLATES:
        return _TEMPLATES.index(fmt)
    _TEMPLATES.append(fmt)
    return len(_TEMPLATES) - 1


def encode(template_id: int, *slots: int) -> np.ndarray:
    """Build a `(MISSION_LEN,)` int32 mission vector."""
    vec = np.zeros(MISSION_LEN, dtype=np.int32)
    vec[0] = template_id
    for i, s in enumerate(slots):
        vec[1 + i] = s
    return vec
