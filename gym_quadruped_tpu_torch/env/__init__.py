"""Environment layer of the port: the batched QuadrupedEnv, the mixed-robot
batch and their state."""

from gym_quadruped_tpu_torch.env.env import QuadrupedEnv
from gym_quadruped_tpu_torch.env.mixed import MixedQuadrupedEnv
from gym_quadruped_tpu_torch.env.observables import ALL_OBS
from gym_quadruped_tpu_torch.env.state import EnvState, init_state

__all__ = ['QuadrupedEnv', 'MixedQuadrupedEnv', 'EnvState', 'init_state', 'ALL_OBS']
