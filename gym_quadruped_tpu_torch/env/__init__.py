"""Environment layer of the port: the batched QuadrupedEnv and its state."""

from gym_quadruped_tpu_torch.env.env import QuadrupedEnv
from gym_quadruped_tpu_torch.env.observables import ALL_OBS
from gym_quadruped_tpu_torch.env.state import EnvState, init_state

__all__ = ['QuadrupedEnv', 'EnvState', 'init_state', 'ALL_OBS']
