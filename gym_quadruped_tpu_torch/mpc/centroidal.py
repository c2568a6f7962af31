"""Centroidal (single-rigid-body) dynamics model for convex quadruped MPC.

Counterpart of gym_quadruped_tpu/mpc/centroidal.py: the yaw-linearized SRB
model of the convex-MPC formulation, with state
    x = [theta (rpy), p, omega (world), v, 1] in R^13
(gravity folded into the constant-augmented state) and inputs the stacked
ground-reaction forces f in R^12 at the feet, frozen over the horizon:

    theta' = Rz(psi)^T omega,   p' = v,
    omega' = I_w^-1 sum r_i x f_i  (I_w = Rz I_b Rz^T),   v' = sum f_i / m + g,

discretized by forward Euler at the MPC dt. Every builder is batched over a
leading env axis B (the reference vmaps a per-env function); the horizon's
knots are one more batch axis, not a loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import Model
from gym_quadruped_tpu_torch.utils.maths import quat_to_mat, skew

NX = 13   # state dim
NU = 12   # 4 legs x 3 force components


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """(4,) wxyz -> (3, 3), in numpy float64 (utils/maths.py's formula)."""
    w, x, y, z = np.asarray(q, np.float64)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ])


@dataclasses.dataclass(frozen=True)
class CentroidalParams:
    mass: float
    inertia_body: np.ndarray  # (3, 3) base rotational inertia in the body frame
    mu: float = 0.7           # friction coefficient for the force cone
    fz_min: float = 0.0
    fz_max: float = 500.0

    @classmethod
    def from_model(cls, m: Model, **kw) -> 'CentroidalParams':
        """The whole robot's mass and the base body's rotational inertia
        about its CoM in the body frame (numpy float64), as the reference."""
        total_mass = float(np.sum(m.body_mass))
        b = m.base_body_id
        R = _quat_to_mat_np(m.body_iquat[b])
        I_b = R @ np.diag(m.body_inertia[b]) @ R.T
        return cls(mass=total_mass, inertia_body=I_b, **kw)


def rz(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(yaw.shape + (3, 3))


def srb_dynamics(params: CentroidalParams, yaw, feet_pos_rel, contact, dt, gravity=-9.81,
                 inertia_body=None):
    """Discrete SRB matrices of one knot, over any leading batch shape (...).

    Args:
        yaw: (...) current yaw (the linearization point).
        feet_pos_rel: (..., 4, 3) foot positions relative to the CoM, world frame.
        contact: (..., 4) stance flags; swing legs' force columns are zeroed.
        dt: MPC step.
        inertia_body: (3, 3) params.inertia_body as a tensor on the device,
            where the caller keeps one; else copied from params on each call.
    Returns:
        A (..., 13, 13), B (..., 13, 12).
    """
    if inertia_body is None:
        inertia_body = torch.as_tensor(params.inertia_body, dtype=feet_pos_rel.dtype).to(
            feet_pos_rel.device)
    R = rz(yaw)
    Rt = R.transpose(-1, -2)
    I_w = R @ inertia_body @ Rt
    I_inv = torch.linalg.inv_ex(I_w)[0]   # inv_ex: no error check, no host sync
    eye3 = torch.eye(3, dtype=feet_pos_rel.dtype, device=feet_pos_rel.device)

    A = feet_pos_rel.new_zeros(yaw.shape + (NX, NX))
    A[..., 0:3, 6:9] = Rt                    # theta' = Rz^T omega
    A[..., 3:6, 9:12] = eye3                 # p' = v
    A[..., 11, 12] = gravity                 # v_z' += g * 1
    A = torch.eye(NX, dtype=A.dtype, device=A.device) + A * dt

    top = I_inv[..., None, :, :] @ skew(feet_pos_rel)   # (..., 4, 3, 3): I^-1 (r x f)
    Bi = feet_pos_rel.new_zeros(feet_pos_rel.shape[:-1] + (NX, 3))   # (..., 4, 13, 3)
    Bi[..., 6:9, :] = top
    Bi[..., 9:12, :] = eye3 / params.mass
    Bi = Bi * contact[..., None, None]
    B = Bi.movedim(-3, -2).reshape(Bi.shape[:-3] + (NX, NU)) * dt
    return A, B


def build_horizon(params: CentroidalParams, yaw, feet_pos_rel, schedule, dt, inertia_body=None):
    """(B, H, 13, 13), (B, H, 13, 12) from yaw (B,), feet_pos_rel (B, 4, 3)
    frozen over the horizon (the classic convex-MPC simplification) and the
    gait schedule (B, H, 4); `inertia_body` as in `srb_dynamics`."""
    H = schedule.shape[1]
    A, B = srb_dynamics(params, yaw[:, None].expand(-1, H),
                        feet_pos_rel[:, None].expand(-1, H, -1, -1), schedule, dt,
                        inertia_body=inertia_body)
    return A, B


def state_from_env(qpos, qvel, base_euler):
    """(B, 13) SRB state from qpos (B, nq), qvel (B, nv) and the base's
    Euler angles (B, 3); omega in the world frame."""
    R = quat_to_mat(qpos[:, 3:7])
    omega_w = (R @ qvel[:, 3:6, None])[..., 0]
    one = qpos.new_ones(qpos.shape[0], 1)
    return torch.cat([base_euler, qpos[:, 0:3], omega_w, qvel[:, 0:3], one], -1)


def reference_trajectory(x0, ref_lin_vel_w, ref_yaw_dot, height, horizon, dt):
    """(B, H, 13) tracking reference: the commanded twist (B, 3) world and
    yaw rate (B,) integrated from x0 (B, 13) at the standing height."""
    ks = torch.arange(1, horizon + 1, dtype=x0.dtype, device=x0.device) * dt
    yaw = x0[:, 2:3] + ks * ref_yaw_dot[:, None]
    p = x0[:, None, 3:6] + ks[:, None] * ref_lin_vel_w[:, None, :]
    xs = x0.new_zeros(x0.shape[0], horizon, NX)
    xs[..., 2] = yaw
    xs[..., 3:5] = p[..., 0:2]
    xs[..., 5] = height
    xs[..., 8] = ref_yaw_dot[:, None]
    xs[..., 9:12] = ref_lin_vel_w[:, None, :]
    xs[..., 12] = 1.0
    return xs
