"""Host-side compatibility (counterpart of `minigrid_tpu/compat/`): the
gymnasium adapter, the old-gym 4-tuple shim, the class-based wrapper set
under the reference's names (wrappers.py:~12-345), and the bit-exact
MT19937 layout replayer.

The names below load their modules on first use, so that `compat.exact`,
`compat.seeding` and `compat.host_env` import without gymnasium; the
adapter and the wrapper classes need it.
"""

import importlib

_EXPORTS = {
    "MiniGridGymEnv": "gym_env",
    "OldGymShim": "gym_env",
    "gym_make": "gym_env",
    "register_all_gymnasium": "gym_env",
    "ReseedWrapper": "host_wrappers",
    "ActionBonus": "host_wrappers",
    "StateBonus": "host_wrappers",
    "ImgObsWrapper": "host_wrappers",
    "OneHotPartialObsWrapper": "host_wrappers",
    "RGBImgObsWrapper": "host_wrappers",
    "RGBImgPartialObsWrapper": "host_wrappers",
    "FullyObsWrapper": "host_wrappers",
    "FlatObsWrapper": "host_wrappers",
    "ViewSizeWrapper": "host_wrappers",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
