"""Smooth dynamics, batched over envs: CRBA mass matrix, RNE bias, passive and
actuator forces.

Counterpart of gym_quadruped_tpu/physics/dynamics.py (MuJoCo's mj_crb /
mj_rne / mj_passive / mj_fwdActuation). Spatial vectors are (omega; v) about
the robot CoM in world axes. The tree recursions are written as products with
static ancestor/subtree masks: with cdof about one common origin, a body's
velocity is the sum of its ancestor dofs' contributions, and composite
inertias and forces are subtree sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import BALL, FREE, HINGE, SLIDE, DeviceModel, Model
from gym_quadruped_tpu_torch.physics.kinematics import (
    Kin,
    spatial_origin,
    subtree_matrix,
)
from gym_quadruped_tpu_torch.utils.maths import skew


@functools.lru_cache(maxsize=64)
def dof_ancestor_mask(m: Model) -> np.ndarray:
    """mask[i, j] = 1 iff dof j is dof i or an ancestor of dof i (the static
    sparsity pattern of the mass matrix's lower triangle)."""
    mask = np.zeros((m.nv, m.nv), np.float64)
    for i in range(m.nv):
        j = i
        while j >= 0:
            mask[i, j] = 1.0
            j = int(m.dof_parentid[j])
    return mask


def _body_dof_masks(m: Model):
    """(nbody, nv) static masks: dofs on the chain from the world to each body
    (inclusive), and each body's own dofs whose axes move with the body (all
    but the free joint's world-fixed translation dofs)."""
    chain = np.zeros((m.nbody, m.nv))
    own_moving = np.zeros((m.nbody, m.nv))
    for b in range(1, m.nbody):
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        own_moving[b, adr:adr + num] = 1.0
        for j in range(int(m.body_jntadr[b]), int(m.body_jntadr[b]) + int(m.body_jntnum[b])):
            if int(m.jnt_type[j]) == FREE:
                a = int(m.jnt_dofadr[j])
                own_moving[b, a:a + 3] = 0.0
        p = b
        while p > 0:
            a, n = int(m.body_dofadr[p]), int(m.body_dofnum[p])
            chain[b, a:a + n] = 1.0
            p = int(m.body_parentid[p])
    return chain, own_moving


def _joint_pairs(m: Model):
    """Each pair of joints (j, k), j before k, on one body: (P, nv) masks of
    j's dofs whose axes move with the body and of all k's dofs, and (P,) the
    body."""
    ndof = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}
    first, second, body = [], [], []
    for b in range(1, m.nbody):
        joints = range(int(m.body_jntadr[b]), int(m.body_jntadr[b]) + int(m.body_jntnum[b]))
        for j in joints:
            for k in joints:
                if k <= j:
                    continue
                rows = np.zeros((2, m.nv))
                for row, jk in zip(rows, (j, k)):
                    a = int(m.jnt_dofadr[jk])
                    row[a:a + ndof[int(m.jnt_type[jk])]] = 1.0
                if int(m.jnt_type[j]) == FREE:
                    rows[0, int(m.jnt_dofadr[j]):int(m.jnt_dofadr[j]) + 3] = 0.0
                first.append(rows[0])
                second.append(rows[1])
                body.append(b)
    return np.array(first), np.array(second), np.array(body, np.int64)


def _velocity_product(dm: DeviceModel, vel: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """(B, nbody, 6) each body's velocity-product acceleration (mj_comVel's
    cdof_dot times qvel, summed down the chain) from the bodies' velocities
    `vel` and qc = qvel * cdof (B, nv, 6): over the chain, v_b x vJ_b, where
    vJ_b counts only the dofs whose axes move with body b (a free joint's
    translation axes are fixed in the world). A body's later joints do not
    move its earlier joints' axes, so where a body has several joints each
    pair (j before k) adds vJ_j x vJ_k."""
    m = dm.m
    own_moving = dm.const('body_own_moving', lambda: _body_dof_masks(m)[1])
    anc = dm.const('body_ancestors', lambda: subtree_matrix(m).T)
    per_body = _cross_motion(vel, torch.einsum('bv,nvk->nbk', own_moving, qc))
    if int(m.body_jntnum.max(initial=0)) > 1:
        first = dm.const('joint_pair_first', lambda: _joint_pairs(m)[0])
        second = dm.const('joint_pair_second', lambda: _joint_pairs(m)[1])
        body = dm.const('joint_pair_body', lambda: _joint_pairs(m)[2])
        pairs = _cross_motion(torch.einsum('pv,nvk->npk', first, qc),
                              torch.einsum('pv,nvk->npk', second, qc))
        per_body = per_body.index_add(1, body, pairs)
    return torch.einsum('ba,nak->nbk', anc, per_body)


def spatial_inertia(dm: DeviceModel, kin: Kin) -> torch.Tensor:
    """(B, nbody, 6, 6) spatial inertia of each body about spatial_origin(kin)."""
    R = kin.ximat
    I_c = torch.einsum('nbij,bj,nbkj->nbik', R, dm.body_inertia, R)
    c = kin.xipos - spatial_origin(kin)[:, None, :]
    mass = dm.body_mass[:, None, None]
    eye = dm.const('eye3', lambda: np.eye(3))
    A = I_c + mass * ((c * c).sum(-1)[..., None, None] * eye
                      - c[..., :, None] * c[..., None, :])
    Bm = mass * skew(c)
    C = (mass * eye).expand_as(Bm)
    top = torch.cat([A, Bm], -1)
    bot = torch.cat([Bm.transpose(-1, -2), C], -1)
    return torch.cat([top, bot], -2)


def _cross_motion(v1, v2):
    """Motion x motion: (w1, v1) x (w2, v2) = (w1 x w2, w1 x v2 + v1 x w2)."""
    w1, l1 = v1[..., :3], v1[..., 3:]
    w2, l2 = v2[..., :3], v2[..., 3:]
    return torch.cat([torch.linalg.cross(w1, w2),
                      torch.linalg.cross(w1, l2) + torch.linalg.cross(l1, w2)], -1)


def _cross_force(v, f):
    """Motion x* force: (w, v) x* (n, f) = (w x n + v x f, w x f)."""
    w, l = v[..., :3], v[..., 3:]
    n, p = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, n) + torch.linalg.cross(l, p),
                      torch.linalg.cross(w, p)], -1)


def mass_matrix(dm: DeviceModel, kin: Kin, cdof: torch.Tensor) -> torch.Tensor:
    """(B, nv, nv) joint-space inertia matrix (mj_fullM, armature included)."""
    m = dm.m
    S = dm.const('subtree', lambda: subtree_matrix(m))
    Ic = torch.einsum('pb,nbij->npij', S, spatial_inertia(dm, kin))  # composite
    dof_body = dm.const('dof_bodyid', lambda: m.dof_bodyid)
    F = torch.einsum('nvij,nvj->nvi', Ic[:, dof_body], cdof)           # (B, nv, 6)
    raw = F @ cdof.transpose(1, 2)              # only ancestor entries are meaningful
    lower = raw * dm.const('dof_ancestor', lambda: dof_ancestor_mask(m))
    diag = torch.diagonal(lower, 0, 1, 2)
    M = lower + lower.transpose(1, 2) - torch.diag_embed(diag)
    return M + torch.diag(dm.dof_armature)


def rne_bias(dm: DeviceModel, kin: Kin, qvel: torch.Tensor,
             cdof: torch.Tensor) -> torch.Tensor:
    """(B, nv) qfrc_bias: Coriolis, centrifugal and gravity forces (mj_rne).

    Gravity enters as a base acceleration of -g; the velocity products are
    `_velocity_product`'s."""
    m = dm.m
    chain = dm.const('body_chain', lambda: _body_dof_masks(m)[0])
    S = dm.const('subtree', lambda: subtree_matrix(m))
    I_sp = spatial_inertia(dm, kin)

    qc = qvel[..., None] * cdof                                  # (B, nv, 6)
    vel = torch.einsum('bv,nvk->nbk', chain, qc)                # (B, nbody, 6)
    a0 = torch.cat([torch.zeros_like(dm.gravity), -dm.gravity])
    acc = a0 + _velocity_product(dm, vel, qc)

    Iv = (I_sp @ vel[..., None])[..., 0]
    f = (I_sp @ acc[..., None])[..., 0] + _cross_force(vel, Iv)
    f_sub = torch.einsum('pb,nbk->npk', S, f)                   # subtree sums
    dof_body = dm.const('dof_bodyid', lambda: m.dof_bodyid)
    return (cdof * f_sub[:, dof_body]).sum(-1)


def passive_force(dm: DeviceModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """(B, nv) qfrc_passive: joint damping, and hinge and slide springs
    (mj_passive; as the reference, no ball-joint springs).
    Dof friction loss is a constraint row (constraints.py), not a force here."""
    m = dm.m
    qfrc = -dm.dof_damping * qvel
    spring = [j for j in range(m.njnt)
              if m.jnt_stiffness[j] != 0 and int(m.jnt_type[j]) in (SLIDE, HINGE)]
    if spring:
        qadr = dm.const('spring_qadr', lambda: m.jnt_qposadr[spring])
        dadr = dm.const('spring_dadr', lambda: m.jnt_dofadr[spring])
        k = dm.const('spring_k', lambda: m.jnt_stiffness[spring])
        qfrc = qfrc.clone()
        qfrc[:, dadr] += -k * (qpos[:, qadr] - dm.qpos_spring[qadr])
    return qfrc


def actuator_force(dm: DeviceModel, ctrl: torch.Tensor) -> torch.Tensor:
    """(B, nv) qfrc_actuator of direct-drive joint motors (mj_fwdActuation):
    ctrl clamped to ctrlrange, times gear, clamped to forcerange."""
    m = dm.m
    lo, hi = dm.actuator_ctrlrange[:, 0], dm.actuator_ctrlrange[:, 1]
    limited = dm.const('ctrllimited', lambda: m.actuator_ctrllimited.astype(bool))
    c = torch.where(limited, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    force = c * dm.actuator_gear
    flo, fhi = dm.actuator_forcerange[:, 0], dm.actuator_forcerange[:, 1]
    flim = dm.const('forcelimited', lambda: m.actuator_forcelimited.astype(bool))
    force = torch.where(flim, torch.minimum(torch.maximum(force, flo), fhi), force)
    dof_of_act = dm.const('actuator_dof', lambda: m.jnt_dofadr[m.actuator_trnid])
    return ctrl.new_zeros(ctrl.shape[0], m.nv).index_add_(1, dof_of_act, force)


def body_velocities(dm: DeviceModel, kin: Kin, qvel: torch.Tensor,
                    cdof: torch.Tensor) -> torch.Tensor:
    """(B, nbody, 6) spatial velocity (omega; v) of each body about
    spatial_origin(kin): the sum of its chain's dof contributions."""
    chain = dm.const('body_chain', lambda: _body_dof_masks(dm.m)[0])
    return torch.einsum('bv,nvk->nbk', chain, qvel[..., None] * cdof)


def body_accelerations(dm: DeviceModel, kin: Kin, qvel: torch.Tensor, qacc: torch.Tensor,
                       cdof: torch.Tensor, gravity_offset: bool = True) -> torch.Tensor:
    """(B, nbody, 6) spatial acceleration (alpha; a) of each body about
    spatial_origin(kin) (mj_rnePostConstraint's cacc). With gravity_offset
    the chain starts from -g, the accelerometer's convention (+9.81 z at
    rest). Each body adds its chain's qacc terms and velocity products
    (`_velocity_product`, as in `rne_bias`)."""
    m = dm.m
    chain = dm.const('body_chain', lambda: _body_dof_masks(m)[0])
    vel = body_velocities(dm, kin, qvel, cdof)
    a0 = torch.cat([torch.zeros_like(dm.gravity),
                    -dm.gravity if gravity_offset else torch.zeros_like(dm.gravity)])
    return (a0 + torch.einsum('bv,nvk->nbk', chain, qacc[..., None] * cdof)
            + _velocity_product(dm, vel, qvel[..., None] * cdof))
