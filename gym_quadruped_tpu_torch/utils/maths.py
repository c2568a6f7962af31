"""Quaternion and SO(3) helpers over tensors with any leading batch shape.

Conventions (MuJoCo's): quaternions are (w, x, y, z), unit norm; rotation
matrices are world_R_body (columns are the body axes in world coordinates).
Counterpart: gym_quadruped_tpu/utils/maths.py.
"""

from __future__ import annotations

import torch


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*p, both (..., 4) wxyz."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4): R(q) @ v."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    # v' = v + 2 w (u x v) + 2 u x (u x v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3), angle (...,) -> quaternion (..., 4)."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([torch.cos(half)[..., None], axis * s], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """MuJoCo mju_quatIntegrate: rotate q by the body-frame angular velocity
    omega for dt, q' = q * exp(0.5 * omega * dt)."""
    angle = torch.linalg.vector_norm(omega, dim=-1) * dt
    n = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    axis = omega / torch.clamp_min(n, 1e-12)
    dq = quat_from_axis_angle(axis, angle)
    return quat_normalize(quat_mul(q, dq))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3) extrinsic XYZ Euler angles (roll, pitch,
    yaw), R = Rz(yaw) Ry(pitch) Rx(roll), as scipy's as_euler('xyz')."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def euler_xyz_to_quat(e: torch.Tensor) -> torch.Tensor:
    """(..., 3) extrinsic XYZ (roll, pitch, yaw) -> (..., 4) wxyz; R = Rz Ry Rx."""
    cr, cp, cy = torch.cos(0.5 * e).unbind(-1)
    sr, sp, sy = torch.sin(0.5 * e).unbind(-1)
    return torch.stack([cr * cp * cy + sr * sp * sy,
                        sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy], -1)
