"""Quaternion and SO(3) helpers over tensors with any leading batch shape.

Conventions (MuJoCo's): quaternions are (w, x, y, z), unit norm; rotation
matrices are world_R_body (columns are the body axes in world coordinates).
Counterpart: gym_quadruped_tpu/utils/maths.py.
"""

from __future__ import annotations

import numbers

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


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """(4,) the identity rotation (1, 0, 0, 0)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) the conjugate (w, -x, -y, -z): the inverse rotation."""
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T @ v over (..., 4) and (..., 3)."""
    return quat_rotate(quat_conj(q), v)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, branch-free Shepperd's method: of the
    four candidate solutions the one whose dominant component is largest,
    with w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cand = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    sel = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)], -2)
    idx = cand.argmax(-1, keepdim=True)                         # (..., 1)
    q = torch.take_along_dim(sel, idx[..., None], -2)[..., 0, :]
    q = q * (0.5 / torch.sqrt(torch.clamp_min(torch.take_along_dim(cand, idx, -1), 1e-30)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def angle_between_vectors(v1, v2) -> torch.Tensor:
    """(...,) the heading in the xy plane of the segment from v1 to v2
    (atan2 of the difference v2 - v1, as the reference's math_utils)."""
    d = torch.as_tensor(v2) - torch.as_tensor(v1)
    return torch.atan2(d[..., 1], d[..., 0])


def homogenous_transform(p: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Points (..., 3) through the (..., 4, 4) homogeneous transforms X."""
    return (X[..., :3, :3] @ p[..., None])[..., 0] + X[..., :3, 3]


def process_range(values) -> tuple:
    """A scalar v -> (v, v); a (min, max) pair passes through, both as
    floats. Host-side helper for constructor arguments."""
    if isinstance(values, numbers.Number):
        return (float(values), float(values))
    values = tuple(values)
    if len(values) != 2:
        raise ValueError(f'Invalid range, expected (min, max), got: {values}')
    return (float(values[0]), float(values[1]))
