"""The port's utilities; the package exposes the names the JAX package's
`utils` does, from the port's own modules."""

from carla_driving_rl_agent_torch.utils import math  # noqa: F401
from carla_driving_rl_agent_torch.utils import activations  # noqa: F401
from carla_driving_rl_agent_torch.utils.schedules import DynamicParameter  # noqa: F401
from carla_driving_rl_agent_torch.utils.optimizers import (  # noqa: F401
    OPTIMIZERS, get_optimizer_by_name)
