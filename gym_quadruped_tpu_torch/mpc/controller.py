"""Centroidal MPC controller: gait -> SRB QP -> ground-reaction forces -> torques.

Counterpart of gym_quadruped_tpu/mpc/controller.py, batched over a leading
env axis B: velocity-command tracking MPC at H=12. One `solve()` is: gait
schedule -> SRB (A, B) horizon -> dense condensing -> Newton-Schulz inverse
and fixed-iteration ADMM (mpc/qp.py) -> (B, H, 4, 3) force plan.
`torques()` maps the first knot of the plan to joint torques: stance legs
J^T f through the world foot Jacobians, swing legs a Cartesian PD to a
Raibert-heuristic foothold. Neither reads a value back to the host nor
copies one to the device: their constants are made in `__init__`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.mpc import centroidal as srb
from gym_quadruped_tpu_torch.mpc import qp
from gym_quadruped_tpu_torch.mpc.gait import GaitConfig, contact_schedule, swing_phase
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz, quat_to_mat


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 12
    mpc_dt: float = 0.02
    iterations: int = 30
    # ADMM budget when a warm start from the previous replan is given
    warm_iterations: int = 10
    rho: float = 1e-4
    gait: GaitConfig = GaitConfig('trot')
    weights: qp.MPCWeights = qp.MPCWeights()
    swing_height: float = 0.06
    kp_swing: float = 300.0
    kd_swing: float = 10.0
    # outward lateral bias of the swing foothold (m): keeps the swing calf
    # clear of the stance-side calf
    stance_width_offset: float = 0.05


class CentroidalMPC:
    """Static config and the batched solve and torque map, on the model's
    device and dtype."""

    def __init__(self, model: DeviceModel, config: MPCConfig = MPCConfig(), **params_kw):
        self.model = model
        self.cfg = config
        m = model.m
        self.params = srb.CentroidalParams.from_model(m, **params_kw)
        # nominal standing height from the keyframe
        self.stand_height = float(m.key_qpos[0][2]) if m.key_qpos.shape[0] else m.hip_height
        # the solve's host constants, copied to the device once here: a tensor
        # made from host numbers inside `solve` would copy and wait each call
        dev = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=model.dtype).to(
            model.device)
        self._gait_offsets = dev(config.gait.resolved()[0])
        self._inertia_body = dev(self.params.inertia_body)
        self._q_diag = dev(config.weights.q_diag)

    # ------------------------------------------------------------------ solve

    def solve(self, qpos, qvel, feet_pos_w, t, ref_lin_vel_w, ref_yaw_dot, warmstart=None):
        """One MPC solve of B envs: qpos (B, nq), qvel (B, nv), feet_pos_w
        (B, 4, 3) world foot positions (frozen over the horizon), t (B,),
        ref_lin_vel_w (B, 3), ref_yaw_dot (B,). Returns (forces (B, H, 4, 3)
        world frame, warm start (U, z, y)); a warm start runs
        `warm_iterations` ADMM iterations, a cold solve `iterations`."""
        cfg = self.cfg
        Hq, qv, schedule = self.condensed_qp(qpos, qvel, feet_pos_w, t, ref_lin_vel_w,
                                             ref_yaw_dot)
        iters = cfg.iterations if warmstart is None else cfg.warm_iterations
        U, warm = qp.admm_solve(Hq, qv, schedule, self.params.mu, self.params.fz_min,
                                self.params.fz_max, iterations=iters, rho=cfg.rho,
                                warmstart=warmstart)
        return U.reshape(-1, cfg.horizon, 4, 3), warm

    def condensed_qp(self, qpos, qvel, feet_pos_w, t, ref_lin_vel_w, ref_yaw_dot):
        """(Hq (B, n, n), q (B, n), schedule (B, H, 4)): the QP that `solve`
        hands to the ADMM, n = 12 H."""
        cfg = self.cfg
        euler = quat_to_euler_xyz(qpos[:, 3:7])
        x0 = srb.state_from_env(qpos, qvel, euler)

        schedule = contact_schedule(cfg.gait, t, cfg.horizon, cfg.mpc_dt, self._gait_offsets)
        com = qpos[:, 0:3]
        A, B = srb.build_horizon(self.params, euler[:, 2], feet_pos_w - com[:, None, :],
                                 schedule, cfg.mpc_dt, inertia_body=self._inertia_body)
        x_ref = srb.reference_trajectory(x0, ref_lin_vel_w, ref_yaw_dot, self.stand_height,
                                         cfg.horizon, cfg.mpc_dt)
        Hq, qv = qp.condense(A, B, x0, x_ref, self._q_diag, cfg.weights.r_diag)
        return Hq, qv, schedule

    # ---------------------------------------------------------------- torques

    def torques(self, qpos, qvel, feet_pos_w, feet_jac_w, grf_plan, t, ref_lin_vel_w,
                qfrc_bias_legs=None):
        """(B, nu) joint torques from the first knot of the force plan.

        feet_jac_w: (B, 4, 3, nv) world translational foot Jacobians.
        grf_plan: (B, 4, 3) first-knot ground-reaction forces.
        qfrc_bias_legs: (B, 4, 3) or None, added on the swing legs.
        """
        dm = self.model
        m = dm.m
        cfg = self.cfg
        stance = contact_schedule(cfg.gait, t, 1, cfg.mpc_dt, self._gait_offsets)[:, 0]  # (B, 4)
        sw_phase = swing_phase(cfg.gait, t, self._gait_offsets)                      # (B, 4)

        # swing foothold: Raibert heuristic under the hip + half-stance travel
        R = quat_to_mat(qpos[:, 3:7])
        hip_w = self._hip_positions_w(qpos, R)
        duty = cfg.gait.resolved()[1]
        t_stance = duty * cfg.gait.period
        v = qvel[:, 0:3]
        side = dm.const('mpc_side', lambda: np.array([1.0, -1.0, 1.0, -1.0]))  # FL FR RL RR
        foothold = hip_w + 0.5 * t_stance * ref_lin_vel_w[:, None, :] \
            + 0.03 * (v - ref_lin_vel_w)[:, None, :] \
            + cfg.stance_width_offset * side[None, :, None] * R[:, None, :, 1]
        ground_z = feet_pos_w[:, :, 2].amin(-1)
        foothold[:, :, 2] = ground_z[:, None]

        # swing trajectory: cycloidal interpolation lift
        lift = cfg.swing_height * torch.sin(math.pi * sw_phase)
        p_des = feet_pos_w * (1 - sw_phase[..., None]) + foothold * sw_phase[..., None]
        p_des[:, :, 2] += lift

        foot_vel = (feet_jac_w @ qvel[:, None, :, None])[..., 0]        # (B, 4, 3)
        f_swing = cfg.kp_swing * (p_des - feet_pos_w) - cfg.kd_swing * foot_vel
        f_cmd = torch.where(stance[..., None] > 0, -grf_plan, f_swing)  # (B, 4, 3)

        tau = (feet_jac_w.transpose(-1, -2) @ f_cmd[..., None])[..., 0].sum(1)   # (B, nv)
        # project to the actuated joints (per-leg tau indices)
        idx_v = dm.const('mpc_legs_qvel_idx', lambda: np.asarray(m.legs_qvel_idx))
        idx_u = dm.const('mpc_legs_tau_idx', lambda: np.asarray(m.legs_tau_idx).reshape(-1))
        leg_tau = tau[:, idx_v]                                         # (B, 4, 3)
        if qfrc_bias_legs is not None:
            leg_tau = leg_tau + qfrc_bias_legs * (1 - stance)[..., None]
        tau_act = tau.new_zeros(tau.shape[0], m.nu)
        tau_act[:, idx_u] = leg_tau.reshape(tau.shape[0], -1)
        return tau_act

    def _hip_positions_w(self, qpos, R=None):
        """(B, 4, 3) hip positions from the base pose and the static hip
        offsets (one body_pos hop from the base for every robot)."""
        dm = self.model
        m = dm.m
        if R is None:
            R = quat_to_mat(qpos[:, 3:7])
        offs = dm.const('mpc_hip_offsets', lambda: np.stack([
            np.zeros(3) if b < 0 else np.asarray(m.body_pos[b], np.float64)
            for b in np.asarray(m.hip_body_id)]))
        return qpos[:, None, 0:3] + offs @ R.transpose(-1, -2)
