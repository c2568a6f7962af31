"""The sensor protocol, batched over envs.

Counterpart of gym_quadruped_tpu/sensors/base.py. A sensor is a static
configuration object; its per-env state is a dataclass of (B, ...) tensors
held in EnvState.sensors, one slot per sensor, in the env's order:

  init(generator, B) -> state0               # (B, ...) tensors on the model's device
  step(ss, qpos, qvel, fwd, generator) -> ss'   # qpos, qvel PRE-step (MuJoCo's
                                             # sensordata), fwd the step's Forward
  get_observation(name, ss) -> (B, dim) tensor
  available_observations() -> tuple of names
  observation_dim(name) -> int

As for the env, randomness comes from a `torch.Generator` that the caller
passes: the state holds no PRNG key. A sensor that draws noise raises
ValueError when it is stepped without one. Every sensor can also be driven
by hand on any batch of states.
"""

from __future__ import annotations

import abc


class Sensor(abc.ABC):
    """Static sensor configuration; per-env state flows through EnvState.sensors."""

    @abc.abstractmethod
    def available_observations(self) -> tuple:
        ...

    @abc.abstractmethod
    def observation_dim(self, name: str) -> int:
        ...

    def init(self, generator, B: int):
        """The initial state of B envs."""
        return ()

    def step(self, ss, qpos, qvel, fwd, generator=None):
        """The state after a physics step from (qpos, qvel), whose Forward is fwd."""
        return ss

    @abc.abstractmethod
    def get_observation(self, name: str, ss):
        ...
