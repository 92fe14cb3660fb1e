"""Environment families; importing the package registers the ported ids."""

from minigrid_tpu_torch.envs import _register_all  # noqa: F401
