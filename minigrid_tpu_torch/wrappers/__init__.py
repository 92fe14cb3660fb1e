"""Observation/reward wrappers — functional equivalents of the reference's
`gym_minigrid/wrappers.py` (counterpart of `minigrid_tpu/wrappers/`)."""

from minigrid_tpu_torch.wrappers.wrappers import (
    CountedEnv,
    action_bonus,
    full_obs,
    img_obs,
    one_hot_partial_obs,
    rgb_img_obs,
    rgb_img_partial_obs,
    state_bonus,
    view_size,
)

__all__ = [
    "img_obs",
    "full_obs",
    "one_hot_partial_obs",
    "rgb_img_obs",
    "rgb_img_partial_obs",
    "view_size",
    "CountedEnv",
    "action_bonus",
    "state_bonus",
]
