"""Forward dynamics and the semi-implicit Euler step, batched over envs.

Counterpart of gym_quadruped_tpu/physics/engine.py (mj_forward / mj_step).
Per step: FK -> cdof -> CRBA M -> RNE bias -> passive -> actuation -> smooth
solve -> narrow phase -> constraint assembly -> Newton solve -> Euler with
implicit joint damping. On the card the smooth solve and the damped Euler
update each launch the SPD kernel once and the Newton solve launches the
fused Newton kernel once; on the CPU the same calls run their plain
versions. Every tensor has a leading env axis B; there is one batched
implementation, held in the tests against both the reference's per-env
`step` and its vmapped `step_batched`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from gym_quadruped_tpu_torch.models.model import BALL, FREE, HINGE, SLIDE, DeviceModel
from gym_quadruped_tpu_torch.ops import newton_fused
from gym_quadruped_tpu_torch.ops.spd_solve import spd_solve_batched
from gym_quadruped_tpu_torch.physics import dynamics
from gym_quadruped_tpu_torch.physics.collision import Contacts, collide
from gym_quadruped_tpu_torch.physics.constraints import (
    Efc,
    constraint_layout,
    make_efc,
    scatter_cone_forces,
)
from gym_quadruped_tpu_torch.physics.kinematics import Kin, cdof as _cdof, fk
from gym_quadruped_tpu_torch.utils.maths import quat_integrate

# Newton iteration cap of the reference's step.
DEFAULT_SOLVER_ITERS = 10

# Cap on the cone contacts solved at once: exact whenever no more slots than
# this touch (spot/flat has 10 slots).
MAX_CONE_CONTACTS = 32


@dataclasses.dataclass
class Forward:
    """Forward-dynamics results, each with a leading env axis B."""

    kin: Kin
    cdof: torch.Tensor            # (B, nv, 6)
    M: torch.Tensor               # (B, nv, nv)
    qfrc_bias: torch.Tensor       # (B, nv)
    qfrc_passive: torch.Tensor    # (B, nv)
    qfrc_actuator: torch.Tensor   # (B, nv)
    qfrc_smooth: torch.Tensor     # (B, nv)
    qacc_smooth: torch.Tensor     # (B, nv)
    contacts: Contacts
    efc: Efc
    qacc: torch.Tensor            # (B, nv) constrained acceleration
    efc_force: torch.Tensor       # (B, ns) simple-row forces
    f_cone: torch.Tensor          # (B, C_all, 6) cone forces (contact frame)
    qfrc_constraint: torch.Tensor  # (B, nv)


def forward(dm: DeviceModel, qpos, qvel, ctrl, warmstart=None,
            solver_iterations: int = DEFAULT_SOLVER_ITERS,
            max_contacts: int = MAX_CONE_CONTACTS, qfrc_applied=None,
            con_mu=None) -> Forward:
    """mj_forward for B envs: qpos (B, nq), qvel (B, nv), ctrl (B, nu);
    `qfrc_applied` (B, nv) is added to the smooth force (mjData.qfrc_applied),
    `con_mu` (S, 5) or (B, S, 5) replaces the model's per-slot friction
    (`constraints.runtime_con_mu`). Its stages are named ranges for
    torch.profiler: smooth, contacts (itself narrow_phase, then assembly),
    newton."""
    with record_function('smooth'):
        kin = fk(dm, qpos)
        cdof = _cdof(dm, kin)
        M = dynamics.mass_matrix(dm, kin, cdof)
        bias = dynamics.rne_bias(dm, kin, qvel, cdof)
        passive = dynamics.passive_force(dm, qpos, qvel)
        act = dynamics.actuator_force(dm, ctrl)
        qfrc_smooth = (passive + act - bias if qfrc_applied is None
                       else passive + act + qfrc_applied - bias)
        qacc_smooth = spd_solve_batched(M, qfrc_smooth)
    with record_function('contacts'):
        with record_function('narrow_phase'):
            contacts = collide(dm, kin)
        with record_function('assembly'):
            efc = make_efc(dm, kin, qpos, qvel, contacts, cdof, con_mu=con_mu,
                           max_cone=max_contacts)
    with record_function('newton'):   # one launch of the fused kernel on the card
        qacc, f_simple, f_cone, qfrc_constraint = newton_fused.solve_batched(
            M, qacc_smooth, efc, warmstart=warmstart, iterations=solver_iterations)
    C_all = len(constraint_layout(dm.m).cone_slots)
    if f_cone.shape[1] < C_all:   # culled forces back onto the full slot axis
        f_cone = scatter_cone_forces(efc.cone_sel, f_cone, C_all)
    return Forward(kin=kin, cdof=cdof, M=M, qfrc_bias=bias, qfrc_passive=passive,
                   qfrc_actuator=act, qfrc_smooth=qfrc_smooth,
                   qacc_smooth=qacc_smooth, contacts=contacts, efc=efc,
                   qacc=qacc, efc_force=f_simple, f_cone=f_cone,
                   qfrc_constraint=qfrc_constraint)


def integrate_pos(dm: DeviceModel, qpos, qvel, h: float) -> torch.Tensor:
    """mj_integratePos: position update on the quaternion manifold (a free
    joint's and a ball joint's quaternions), linear for slide and hinge
    joints."""
    m = dm.m
    out = qpos.clone()
    for j in np.flatnonzero((m.jnt_type == FREE) | (m.jnt_type == BALL)):
        qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
        if int(m.jnt_type[j]) == FREE:
            out[:, qadr:qadr + 3] = qpos[:, qadr:qadr + 3] + h * qvel[:, dadr:dadr + 3]
            qadr, dadr = qadr + 3, dadr + 3
        out[:, qadr:qadr + 4] = quat_integrate(qpos[:, qadr:qadr + 4],
                                               qvel[:, dadr:dadr + 3], h)
    linear = lambda: (m.jnt_type == SLIDE) | (m.jnt_type == HINGE)
    qadr = dm.const('linear_qadr', lambda: m.jnt_qposadr[linear()])
    dadr = dm.const('linear_dof', lambda: m.jnt_dofadr[linear()])
    if qadr.numel():
        out[:, qadr] = qpos[:, qadr] + h * qvel[:, dadr]
    return out


def euler(dm: DeviceModel, qpos, qvel, fwd: Forward):
    """mj_Euler: semi-implicit Euler with implicit joint damping, which
    solves (M + h diag(damping)) for the velocity update (profiler range
    `euler`)."""
    h = dm.timestep
    with record_function('euler'):
        qfrc = fwd.qfrc_smooth + fwd.qfrc_constraint
        if np.any(dm.m.dof_damping > 0):
            hB = dm.const('h_damping', lambda: h * np.diag(dm.m.dof_damping))
            qacc_int = spd_solve_batched(fwd.M + hB, qfrc)
        else:
            qacc_int = fwd.qacc
        qvel_new = qvel + h * qacc_int
        return integrate_pos(dm, qpos, qvel_new, h), qvel_new


def step_batched(dm: DeviceModel, qpos, qvel, ctrl, warmstart=None,
                 solver_iterations: int = DEFAULT_SOLVER_ITERS,
                 max_contacts: int = MAX_CONE_CONTACTS, qfrc_applied=None, con_mu=None):
    """mj_step for B envs: returns (qpos', qvel', Forward at the old state)
    on the model's device. Thread `fwd.qacc` back in as the next step's
    `warmstart`. `qfrc_applied` and `con_mu` as in `forward`."""
    fwd = forward(dm, qpos, qvel, ctrl, warmstart, solver_iterations, max_contacts,
                  qfrc_applied, con_mu)
    qpos_new, qvel_new = euler(dm, qpos, qvel, fwd)
    return qpos_new, qvel_new, fwd


def step(dm: DeviceModel, qpos, qvel, ctrl, warmstart=None,
         solver_iterations: int = DEFAULT_SOLVER_ITERS,
         max_contacts: int = MAX_CONE_CONTACTS, qfrc_applied=None, con_mu=None):
    """One env: qpos (nq,), qvel (nv,), ctrl (nu,), qfrc_applied (nv,),
    con_mu (S, 5). `step_batched` on a batch of one; the returned Forward
    keeps its batch axis of one."""
    one = lambda x: None if x is None else x[None]
    qp, qv, fwd = step_batched(dm, qpos[None], qvel[None], ctrl[None], one(warmstart),
                               solver_iterations, max_contacts, one(qfrc_applied),
                               one(con_mu))
    return qp[0], qv[0], fwd
