"""EnvState: the simulation state of a batch of envs.

Counterpart of gym_quadruped_tpu/env/state.py, with every field batched: a
leading env axis B on every tensor. The state holds no PRNG key: the env's
draws come from a `torch.Generator` that the caller passes to `reset` and
`step`, so they are not reproducible against the reference's JAX streams.
A state carries across from the reference through `state_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.sensors import CameraState, HeightMapState, IMUState


@dataclasses.dataclass
class EnvState:
    """The full dynamic state of B envs."""

    qpos: torch.Tensor       # (B, nq)
    qvel: torch.Tensor       # (B, nv)
    ctrl: torch.Tensor       # (B, nu) last applied torque command
    qacc: torch.Tensor       # (B, nv) acceleration of the last solve (the warm start)
    time: torch.Tensor       # (B,) simulation time [s]
    step_num: torch.Tensor   # (B,) int32

    # velocity command (quadruped_env.py:1046-1072)
    ref_base_lin_vel_H: torch.Tensor         # (B, 3) in the heading frame
    ref_base_ang_yaw_dot: torch.Tensor       # (B,)
    steps_until_resample_vel: torch.Tensor   # (B,) int32, -1: never

    # external disturbance (quadruped_env.py:1074-1139)
    external_wrench: torch.Tensor              # (B, 6) on the free joint's dofs
    steps_until_resample_wrench: torch.Tensor  # (B,) int32, -1: never

    # domain randomisation (quadruped_env.py:1277-1298)
    geom_friction: torch.Tensor   # (B, ngeom, 3) per-env friction table

    # per-sensor states (dataclasses of (B, ...) tensors), ordered as env.sensors
    sensors: tuple = ()

    def map(self, fn) -> 'EnvState':
        """The state with `fn` applied to every tensor, the sensors' too."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in tensor_fields(self)},
                        sensors=tuple(_map_sensor(fn, ss) for ss in self.sensors))

    def to(self, device, dtype: torch.dtype) -> 'EnvState':
        """On `device`, float fields in `dtype`."""
        return self.map(lambda x: x.to(device, dtype if x.is_floating_point() else x.dtype))


# integer fields: the state's counters and CameraState's geom ids
INT_FIELDS = ('step_num', 'steps_until_resample_vel', 'steps_until_resample_wrench', 'seg')
# the sensor states a reference state may carry, by class name
SENSOR_STATES = {cls.__name__: cls for cls in (HeightMapState, IMUState, CameraState)}


def tensor_fields(state) -> tuple:
    """The fields of an EnvState that hold one tensor (all but `sensors`)."""
    return tuple(f for f in dataclasses.fields(state) if f.name != 'sensors')


def _map_sensor(fn, ss):
    return dataclasses.replace(ss, **{f.name: fn(getattr(ss, f.name))
                                      for f in dataclasses.fields(ss)})


def init_state(dm: DeviceModel, B: int) -> EnvState:
    """B envs at rest at keyframe 0 (qpos0 without a keyframe), with no
    command, no disturbance and the model's friction. `reset` builds on
    this."""
    m = dm.m
    dev, dtype = dm.device, dm.dtype
    key = m.key_qpos[0] if m.key_qpos.shape[0] else m.qpos0
    zeros = lambda *shape: torch.zeros(B, *shape, dtype=dtype, device=dev)
    never = lambda: torch.full((B,), -1, dtype=torch.int32, device=dev)
    return EnvState(
        qpos=torch.as_tensor(key, dtype=dtype, device=dev).repeat(B, 1),
        qvel=zeros(m.nv), ctrl=zeros(m.nu), qacc=zeros(m.nv), time=zeros(),
        step_num=torch.zeros(B, dtype=torch.int32, device=dev),
        ref_base_lin_vel_H=zeros(3), ref_base_ang_yaw_dot=zeros(),
        steps_until_resample_vel=never(),
        external_wrench=zeros(6), steps_until_resample_wrench=never(),
        geom_friction=dm.geom_friction.expand(B, -1, -1).clone())


def state_from_numpy(arrays, device, dtype: torch.dtype) -> EnvState:
    """The port's state from numpy arrays with a leading env axis: a mapping
    or an object with the field names as attributes, such as the
    reference's batched EnvState with numpy leaves. Its sensor states (the
    reference's HeightMapState, IMUState and CameraState, in the env's
    order) become the port's; its PRNG keys (the state's and the IMU's) are
    not read."""
    mapping = isinstance(arrays, Mapping)
    get = arrays.__getitem__ if mapping else lambda k: getattr(arrays, k)
    as_tensor = lambda a, name: torch.tensor(
        np.asarray(a), device=device, dtype=torch.int32 if name in INT_FIELDS else dtype)
    out = {f.name: as_tensor(get(f.name), f.name) for f in tensor_fields(EnvState)}
    sensors = []
    for ss in (arrays.get('sensors', ()) if mapping else getattr(arrays, 'sensors', ())):
        cls = SENSOR_STATES[type(ss).__name__]
        sensors.append(cls(**{f.name: as_tensor(getattr(ss, f.name), f.name)
                              for f in dataclasses.fields(cls)}))
    return EnvState(**out, sensors=tuple(sensors))
