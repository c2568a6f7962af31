"""The 31 observables of the reference env, batched over envs.

Counterpart of gym_quadruped_tpu/env/observables.py (the reference's
QuadrupedEnv._get_obs, quadruped_env.py:1146-1226, and the accessors it
calls, :488-1007). Each observable is an expression over one Forward of B
envs; an observable that is not asked for is not computed (feet Jacobians,
contact state and forces only when one needs them).

Frame semantics, kept as the reference has them:
  * qvel[0:3] is the base linear velocity in the world frame, qvel[3:6] the
    base angular velocity in the body frame (MuJoCo's free joint).
  * After mj_step the kinematic registers (geom_xpos, Jacobians, contacts,
    qacc, qM) belong to the state before the step while qpos and qvel are
    after it. The reference reads both, and so does this module: `fwd` is
    the forward dynamics at the state before the step, qpos and qvel after.
  * feet_vel_rel subtracts qvel[3:6] x (p_foot - p_base) with the raw
    body-frame qvel[3:6] as if it were a world angular velocity
    (quadruped_env.py:655-663).
  * kinetic_energy and work follow the reference's intended semantics (its
    code raises NameError, quadruped_env.py:939-954).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import Model
from gym_quadruped_tpu_torch.physics.constraints import _point_jacobians
from gym_quadruped_tpu_torch.physics.forces import feet_contact_forces, feet_contact_state
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz, quat_to_mat

BASE_OBS = [
    'base_pos', 'base_lin_vel', 'base_lin_vel_err', 'base_lin_acc',
    'base_ang_vel', 'base_ang_vel_err', 'base_ori_euler_xyz',
    'base_ori_quat_wxyz', 'base_ori_SO3', 'gravity_vector:base',
]
BASE_OBS_BASE_FRAME = [
    'base_lin_vel:base', 'base_lin_vel_err:base', 'base_lin_acc:base',
    'base_ang_vel:base', 'base_ang_vel_err:base',
]
GEN_COORDS_OBS = ['qpos', 'qvel', 'tau_ctrl_setpoint', 'qpos_js', 'qvel_js',
                  'kinetic_energy', 'work']
FEET_OBS = [
    'feet_pos', 'feet_pos:base', 'feet_vel', 'feet_vel_rel', 'feet_vel:base',
    'feet_vel_rel:base', 'contact_state', 'contact_forces', 'contact_forces:base',
]
ALL_OBS = BASE_OBS + BASE_OBS_BASE_FRAME + GEN_COORDS_OBS + FEET_OBS


def obs_dim(m: Model, name: str) -> int:
    """Observation dims (reference configure_observation_space,
    quadruped_utils.py:235-325)."""
    base = name.split(':')[0]
    if name == 'qpos':
        return m.nq
    if name == 'qvel':
        return m.nv
    if name == 'tau_ctrl_setpoint':
        return m.nu
    if name == 'qpos_js':
        return m.nq - 7
    if name == 'qvel_js':
        return m.nv - 6
    if base in ('base_pos', 'base_lin_vel', 'base_lin_vel_err', 'base_lin_acc',
                'base_ang_vel', 'base_ang_vel_err', 'base_ori_euler_xyz',
                'gravity_vector'):
        return 3
    if base == 'base_ori_quat_wxyz':
        return 4
    if base == 'base_ori_SO3':
        return 9
    if base.startswith('feet_pos') or base.startswith('feet_vel'):
        return 12
    if base == 'contact_state':
        return 4
    if base.startswith('contact_forces'):
        return 12
    if base.startswith('imu'):
        return 3
    if base in ('work', 'kinetic_energy'):
        return 1
    raise ValueError(f'Invalid observation name: {name}, available: {ALL_OBS}')


def obs_limits(m: Model, name: str) -> tuple[np.ndarray, np.ndarray]:
    """(low, high) bounds of an observable (reference
    configure_observation_space, quadruped_utils.py:235-325): joint ranges
    bound qpos and qpos_js, the control range tau_ctrl_setpoint, [0, 1]
    contact_state, everything else +-inf. As the reference, it takes
    jnt_range[1:]: joint 0 is the free joint, every other joint has one
    qpos."""
    dim = obs_dim(m, name)
    lo = np.full(dim, -np.inf)
    hi = np.full(dim, np.inf)
    jr = np.asarray(m.jnt_range)
    if name == 'qpos':
        lo[7:] = jr[1:, 0]
        hi[7:] = jr[1:, 1]
    elif name == 'qpos_js':
        lo[:] = jr[1:, 0]
        hi[:] = jr[1:, 1]
    elif name == 'tau_ctrl_setpoint':
        cr = np.asarray(m.actuator_ctrlrange)
        lo[:] = cr[:, 0]
        hi[:] = cr[:, 1]
    elif name.split(':')[0] == 'contact_state':
        lo[:] = 0.0
        hi[:] = 1.0
    return lo, hi


def heading_R(qpos: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) yaw-only rotation of the base (reference
    heading_orientation_SO3, quadruped_env.py:989)."""
    yaw = quat_to_euler_xyz(qpos[:, 3:7])[:, 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(-1, 3, 3)


def target_base_vel(qpos, ref_lin_vel_H, ref_yaw_dot):
    """(B, 3), (B, 3): the velocity command in the world frame (reference
    target_base_vel, quadruped_env.py:488-499)."""
    ref_lin = (heading_R(qpos) @ ref_lin_vel_H[..., None])[..., 0]
    z = torch.zeros_like(ref_yaw_dot)
    return ref_lin, torch.stack([z, z, ref_yaw_dot], -1)


def compute_obs(dm, names, qpos, qvel, ctrl, fwd, ref_lin_vel_H, ref_yaw_dot) -> dict:
    """{name: (B, obs_dim)} for `names`; qpos, qvel and ctrl after the step,
    `fwd` at the state before it."""
    m = dm.m
    R = quat_to_mat(qpos[:, 3:7])      # world <- base, after the step
    base_pos = qpos[:, 0:3]
    lin_w = qvel[:, 0:3]               # world frame
    ang_b = qvel[:, 3:6]               # body frame
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    ang_w = mv(R, ang_b)

    @functools.cache
    def feet():
        """Feet positions and velocities (B, 4, 3), world frame, from the
        Forward before the step."""
        pos = fwd.kin.geom_xpos[:, dm.const('feet_geom_id', lambda: m.feet_geom_id)]
        jacp, _ = _point_jacobians(dm, fwd.kin, fwd.cdof, pos, m.feet_body_id)
        vel = (jacp @ qvel[:, None, :, None])[..., 0]
        # relative: minus the base's linear velocity and qvel[3:6] x (p_foot - p_base)
        rel = (vel - lin_w[:, None, :]
               - torch.linalg.cross(ang_b[:, None, :].expand(-1, 4, -1),
                                    pos - base_pos[:, None, :]))
        return pos, vel, rel

    @functools.cache
    def ref_vel():
        return target_base_vel(qpos, ref_lin_vel_H, ref_yaw_dot)

    out = {}
    for name in names:
        base_name, _, frame = name.partition(':')
        base = frame == 'base'
        rot = (lambda v: mv(R.transpose(1, 2), v)) if base else (lambda v: v)
        rot_feet = ((lambda f: (f @ R).reshape(-1, 12)) if base
                    else (lambda f: f.reshape(-1, 12)))   # rows R' f_i

        if name == 'qpos':
            v = qpos
        elif name == 'qvel':
            v = qvel
        elif name == 'tau_ctrl_setpoint':
            v = ctrl
        elif name == 'qpos_js':
            v = qpos[:, 7:]
        elif name == 'qvel_js':
            v = qvel[:, 6:]
        elif name == 'base_pos':
            v = base_pos
        elif base_name == 'base_lin_vel_err':
            v = rot(ref_vel()[0]) - rot(lin_w)
        elif base_name == 'base_lin_vel':
            v = rot(lin_w)
        elif base_name == 'base_lin_acc':
            v = rot(fwd.qacc[:, 0:3])
        elif base_name == 'base_ang_vel_err':
            # base frame: the raw body-frame qvel[3:6]; world: R qvel[3:6]
            v = rot(ref_vel()[1]) - (ang_b if base else ang_w)
        elif base_name == 'base_ang_vel':
            v = ang_b if base else ang_w
        elif name == 'base_ori_euler_xyz':
            v = quat_to_euler_xyz(qpos[:, 3:7])
        elif name == 'base_ori_quat_wxyz':
            v = qpos[:, 3:7]
        elif name == 'base_ori_SO3':
            v = R.reshape(-1, 9)
        elif base_name == 'feet_pos':
            pos = feet()[0]
            v = (pos.reshape(-1, 12) if not base
                 else ((pos - base_pos[:, None, :]) @ R).reshape(-1, 12))
        elif base_name == 'feet_vel_rel':
            v = rot_feet(feet()[2])
        elif base_name == 'feet_vel':
            v = rot_feet(feet()[1])
        elif name == 'contact_state':
            v = feet_contact_state(dm, fwd).to(qpos.dtype)
        elif base_name == 'contact_forces':
            v = rot_feet(feet_contact_forces(dm, fwd))
        elif name == 'gravity_vector:base':
            v = -R[:, 2, :]    # R' (0, 0, -1)
        elif name == 'kinetic_energy':
            v = 0.5 * (qvel * mv(fwd.M, qvel)).sum(-1, keepdim=True)
        elif name == 'work':
            v = (mv(fwd.M, fwd.qacc) * qvel).sum(-1, keepdim=True)
        else:
            raise ValueError(f'Invalid observation name: {name}, available: {ALL_OBS}')
        out[name] = v
    return out
