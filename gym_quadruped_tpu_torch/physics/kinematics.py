"""Forward kinematics over the kinematic tree, batched over envs.

Counterpart of gym_quadruped_tpu/physics/kinematics.py (MuJoCo's
mj_kinematics / mj_comPos). Every tensor has a leading env axis B; the
per-body loop runs over the static tree in Python, and within a body over its
joints (free, ball, slide, hinge; any number of them per body).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import BALL, FREE, HINGE, SLIDE, DeviceModel, Model
from gym_quadruped_tpu_torch.utils.maths import (
    quat_from_axis_angle,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
)


@dataclasses.dataclass
class Kin:
    """World-frame pose quantities, each with a leading env axis B."""

    xpos: torch.Tensor        # (B, nbody, 3) body frame origin
    xquat: torch.Tensor       # (B, nbody, 4) body frame orientation
    xipos: torch.Tensor       # (B, nbody, 3) body CoM position
    ximat: torch.Tensor       # (B, nbody, 3, 3) inertial frame orientation
    xanchor: torch.Tensor     # (B, njnt, 3) joint anchor
    xaxis: torch.Tensor       # (B, njnt, 3) joint axis
    geom_xpos: torch.Tensor   # (B, ngeom, 3)
    geom_xmat: torch.Tensor   # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor   # (B, nsite, 3)
    site_xmat: torch.Tensor   # (B, nsite, 3, 3)
    subtree_com: torch.Tensor  # (B, nbody, 3) CoM of each body's subtree


def check_joints(m: Model):
    """Raise for a joint type that is not MuJoCo's free, ball, slide or hinge."""
    bad = sorted({int(t) for t in m.jnt_type} - {FREE, BALL, SLIDE, HINGE})
    if bad:
        raise NotImplementedError(f'unknown joint types {bad} (free=0, ball=1, slide=2, '
                                  f'hinge=3)')


def subtree_matrix(m: Model) -> np.ndarray:
    """(nbody, nbody) 0/1: [p, b] = 1 iff body b lies in the subtree of p."""
    S = np.eye(m.nbody)
    for b in range(m.nbody - 1, 0, -1):
        S[int(m.body_parentid[b])] += S[b]
    return S


def fk(dm: DeviceModel, qpos: torch.Tensor) -> Kin:
    """mj_kinematics: body/geom/site world poses from qpos (B, nq)."""
    m = dm.m
    check_joints(m)
    B = qpos.shape[0]
    dtype, dev = qpos.dtype, qpos.device
    qpos0 = dm.qpos0

    xpos = [torch.zeros(B, 3, dtype=dtype, device=dev)]
    xquat = [dm.const('quat_identity', lambda: np.array([1.0, 0.0, 0.0, 0.0])).expand(B, 4)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt

    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        pos = xpos[p] + quat_rotate(xquat[p], dm.body_pos[b])
        quat = quat_mul(xquat[p], dm.body_quat[b])
        for j in range(int(m.body_jntadr[b]), int(m.body_jntadr[b]) + int(m.body_jntnum[b])):
            qadr, jtype = int(m.jnt_qposadr[j]), int(m.jnt_type[j])
            if jtype == FREE:
                pos = qpos[:, qadr:qadr + 3]
                quat = quat_normalize(qpos[:, qadr + 3:qadr + 7])
                xanchor[j] = pos
                xaxis[j] = dm.jnt_axis[j].expand(B, 3)  # free axis is not rotated
            elif jtype == BALL:
                anchor = pos + quat_rotate(quat, dm.jnt_pos[j])
                quat = quat_mul(quat, quat_normalize(qpos[:, qadr:qadr + 4]))
                pos = anchor - quat_rotate(quat, dm.jnt_pos[j])
                xanchor[j] = anchor
                xaxis[j] = quat_rotate(quat, dm.jnt_axis[j])
            elif jtype == SLIDE:
                axis = quat_rotate(quat, dm.jnt_axis[j])
                pos = pos + axis * (qpos[:, qadr] - qpos0[qadr])[:, None]
                xanchor[j] = pos + quat_rotate(quat, dm.jnt_pos[j])
                xaxis[j] = axis
            else:  # HINGE
                anchor = pos + quat_rotate(quat, dm.jnt_pos[j])
                qloc = quat_from_axis_angle(dm.jnt_axis[j], qpos[:, qadr] - qpos0[qadr])
                quat = quat_mul(quat, qloc)
                pos = anchor - quat_rotate(quat, dm.jnt_pos[j])
                xanchor[j] = anchor
                xaxis[j] = quat_rotate(quat, dm.jnt_axis[j])
        xpos.append(pos)
        xquat.append(quat)

    xpos = torch.stack(xpos, 1)
    xquat = torch.stack(xquat, 1)

    xipos = xpos + quat_rotate(xquat, dm.body_ipos)
    ximat = quat_to_mat(quat_mul(xquat, dm.body_iquat))

    gb = dm.const('geom_bodyid', lambda: m.geom_bodyid)
    geom_xpos = xpos[:, gb] + quat_rotate(xquat[:, gb], dm.geom_pos)
    geom_xmat = quat_to_mat(quat_mul(xquat[:, gb], dm.geom_quat))
    if m.nsite > 0:
        sb = dm.const('site_bodyid', lambda: m.site_bodyid)
        site_xpos = xpos[:, sb] + quat_rotate(xquat[:, sb], dm.site_pos)
        site_xmat = quat_to_mat(quat_mul(xquat[:, sb], dm.site_quat))
    else:
        site_xpos = xpos.new_zeros(B, 0, 3)
        site_xmat = xpos.new_zeros(B, 0, 3, 3)

    # subtree CoM (mj_comPos): mass-weighted sums over each body's subtree
    S = dm.const('subtree', lambda: subtree_matrix(m))
    sub_mass = S @ dm.body_mass                                   # (nbody,)
    sub_mom = torch.einsum('pb,nbk->npk', S, dm.body_mass[:, None] * xipos)
    subtree_com = sub_mom / torch.clamp_min(sub_mass, 1e-12)[:, None]

    return Kin(xpos=xpos, xquat=xquat, xipos=xipos, ximat=ximat,
               xanchor=torch.stack(xanchor, 1), xaxis=torch.stack(xaxis, 1),
               geom_xpos=geom_xpos, geom_xmat=geom_xmat,
               site_xpos=site_xpos, site_xmat=site_xmat,
               subtree_com=subtree_com)


def spatial_origin(kin: Kin) -> torch.Tensor:
    """(B, 3) reference point of all (omega; v) spatial vectors: the robot CoM
    (the world body is massless, so subtree_com[:, 0] is the robot's)."""
    return kin.subtree_com[:, 0]


def cdof(dm: DeviceModel, kin: Kin) -> torch.Tensor:
    """(B, nv, 6) per-dof motion subspace vectors (omega; v) about
    spatial_origin(kin). A free joint's angular dofs and a ball joint's three
    dofs are the body-frame axes (about the body origin and the ball's
    anchor); a hinge's is its axis about its anchor, a slide's (0; axis)."""
    m = dm.m
    B = kin.xpos.shape[0]
    c = spatial_origin(kin)
    out = kin.xpos.new_empty(B, m.nv, 6)
    for j in np.flatnonzero((m.jnt_type == FREE) | (m.jnt_type == BALL)):
        adr, b = int(m.jnt_dofadr[j]), int(m.jnt_bodyid[j])
        if int(m.jnt_type[j]) == FREE:
            out[:, adr:adr + 3] = dm.const('eye3x6', lambda: np.eye(3, 6, 3))
            adr, origin = adr + 3, kin.xpos[:, b]
        else:
            origin = kin.xanchor[:, j]
        axes = quat_to_mat(kin.xquat[:, b]).transpose(1, 2)   # rows: body axes
        p = (origin - c)[:, None, :].expand(B, 3, 3)
        out[:, adr:adr + 3] = torch.cat([axes, torch.linalg.cross(p, axes)], -1)
    hinge = dm.const('hinge_jnt', lambda: np.flatnonzero(m.jnt_type == HINGE))
    hdof = dm.const('hinge_dof', lambda: m.jnt_dofadr[m.jnt_type == HINGE])
    if hinge.numel():
        axis = kin.xaxis[:, hinge]
        arm = kin.xanchor[:, hinge] - c[:, None, :]
        out[:, hdof] = torch.cat([axis, torch.linalg.cross(arm, axis)], -1)
    slide = dm.const('slide_jnt', lambda: np.flatnonzero(m.jnt_type == SLIDE))
    sdof = dm.const('slide_dof', lambda: m.jnt_dofadr[m.jnt_type == SLIDE])
    if slide.numel():
        axis = kin.xaxis[:, slide]
        out[:, sdof] = torch.cat([torch.zeros_like(axis), axis], -1)
    return out


def point_jacobian(dm: DeviceModel, kin: Kin, cdof: torch.Tensor, point: torch.Tensor,
                   body_id: int) -> torch.Tensor:
    """(B, 3, nv) translational Jacobian of the world point `point` (B, 3)
    attached to the static body `body_id` (mj_jac): column i is the point's
    velocity under a unit velocity of dof i, zero off the body's chain."""
    rel = point - spatial_origin(kin)                               # (B, 3)
    omega = cdof[..., :3]
    vp = cdof[..., 3:] + torch.linalg.cross(omega, rel[:, None, :].expand_as(omega))
    mask = dm.const(('ancestor_dofs', int(body_id)), lambda: ancestor_dof_mask(dm.m, body_id))
    return (vp * mask[:, None]).transpose(1, 2)


def _free_translation_mask(m: Model) -> np.ndarray:
    """(nv,) 0 on the free joints' translation dofs, 1 elsewhere."""
    mask = np.ones(m.nv)
    for j in np.flatnonzero(m.jnt_type == FREE):
        adr = int(m.jnt_dofadr[j])
        mask[adr:adr + 3] = 0.0
    return mask


def cdof_dot(dm: DeviceModel, kin: Kin, qvel: torch.Tensor, cdof: torch.Tensor) -> torch.Tensor:
    """(B, nv, 6) time derivative of the motion subspace vectors
    (mjData.cdof_dot): v_body x_m S for the axes that move with their body;
    a free joint's translation axes are fixed in the world, so theirs is 0."""
    from gym_quadruped_tpu_torch.physics.dynamics import body_velocities

    bid = dm.const('dof_bodyid', lambda: dm.m.dof_bodyid)
    vel = body_velocities(dm, kin, qvel, cdof)[:, bid]              # (B, nv, 6)
    w, v = vel[..., :3], vel[..., 3:]
    sw, sv = cdof[..., :3], cdof[..., 3:]
    dot = torch.cat([torch.linalg.cross(w, sw),
                     torch.linalg.cross(w, sv) + torch.linalg.cross(v, sw)], -1)
    return dot * dm.const('free_translation_mask', lambda: _free_translation_mask(dm.m))[:, None]


def point_jacobian_dot(dm: DeviceModel, kin: Kin, cdof: torch.Tensor, qvel: torch.Tensor,
                       point: torch.Tensor, body_id: int) -> torch.Tensor:
    """(B, 3, nv) time derivative of `point_jacobian` (mj_jacDot):
    d/dt[v0_i + w_i x (p - c)] = v0dot_i + wdot_i x (p - c) + w_i x v(p),
    (wdot_i; v0dot_i) from `cdof_dot` and v(p) the material velocity of the
    point; the spatial origin c is held fixed, MuJoCo's c-frame convention."""
    from gym_quadruped_tpu_torch.physics.dynamics import body_velocities

    rel = point - spatial_origin(kin)                               # (B, 3)
    dot = cdof_dot(dm, kin, qvel, cdof)
    vel_b = body_velocities(dm, kin, qvel, cdof)[:, body_id]        # (B, 6)
    v_p = vel_b[:, 3:] + torch.linalg.cross(vel_b[:, :3], rel)
    omega = cdof[..., :3]
    jdot = (dot[..., 3:] + torch.linalg.cross(dot[..., :3], rel[:, None, :].expand_as(omega))
            + torch.linalg.cross(omega, v_p[:, None, :].expand_as(omega)))
    mask = dm.const(('ancestor_dofs', int(body_id)), lambda: ancestor_dof_mask(dm.m, body_id))
    return (jdot * mask[:, None]).transpose(1, 2)


def ancestor_dof_mask(m: Model, body_id: int) -> np.ndarray:
    """Static 0/1 mask (nv,) of the dofs on the chain from the world to body."""
    mask = np.zeros(m.nv, np.float64)
    b = body_id
    while b > 0:
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        mask[adr:adr + num] = 1.0
        b = int(m.body_parentid[b])
    return mask
