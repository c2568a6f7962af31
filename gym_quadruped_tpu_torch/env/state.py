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

    def map(self, fn) -> 'EnvState':
        """The state with `fn` applied to every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device, dtype: torch.dtype) -> 'EnvState':
        """On `device`, float fields in `dtype`."""
        return self.map(lambda x: x.to(device, dtype if x.is_floating_point() else x.dtype))


INT_FIELDS = ('step_num', 'steps_until_resample_vel', 'steps_until_resample_wrench')


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
    reference's batched EnvState with numpy leaves (its key and sensor
    states are not read)."""
    get = arrays.__getitem__ if isinstance(arrays, Mapping) else lambda k: getattr(arrays, k)
    out = {}
    for f in dataclasses.fields(EnvState):
        a = np.asarray(get(f.name))
        out[f.name] = torch.tensor(
            a, device=device, dtype=torch.int32 if f.name in INT_FIELDS else dtype)
    return EnvState(**out)
