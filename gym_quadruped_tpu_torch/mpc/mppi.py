"""Sampling-based MPC (MPPI) over the full contact physics.

Counterpart of gym_quadruped_tpu/mpc/mppi.py: Model-Predictive Path
Integral control where every candidate control sequence is rolled out
through the real batched engine (not the SRB approximation), so the planner
sees contacts, joint limits and actuator saturation exactly. The K rollouts
are the batch of one `engine.step_batched` call per horizon step, at the
config's Newton cap and without a warm start (the reference's `engine.step`
inside `lax.scan`), so each horizon step launches the port's kernels once.

    u*_t = sum_k w_k (u_t + eps_k,t),   w_k ~ exp(-cost_k / lambda)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.physics import engine
from gym_quadruped_tpu_torch.utils.maths import quat_to_mat


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 24            # physics steps per rollout (dt = model timestep)
    n_samples: int = 1024        # K scenarios per solve
    sigma: float = 2.0           # exploration noise std [Nm]
    temperature: float = 1.0     # lambda
    solver_iterations: int = 4   # rollouts tolerate a looser contact solve


def velocity_tracking_cost(m: DeviceModel, ref_lin_vel_w, ref_yaw_dot, height,
                           w_vel=10.0, w_height=50.0, w_upright=20.0, w_ctrl=1e-4):
    """Running cost (K,) of K (state, ctrl) pairs for the velocity-command
    task (the env's base_lin_vel_err semantics); the command (3,) and yaw
    rate are copied to the model's device once, here."""
    ref = torch.as_tensor(ref_lin_vel_w, dtype=m.dtype).to(m.device)
    yaw_dot = torch.as_tensor(ref_yaw_dot, dtype=m.dtype).to(m.device)

    def cost(qpos, qvel, ctrl):
        R = quat_to_mat(qpos[:, 3:7])
        vel_err = qvel[:, 0:3] - ref
        yaw_rate_err = (R[:, 2, :] * qvel[:, 3:6]).sum(-1) - yaw_dot
        up_err = 1.0 - R[:, 2, 2]
        h_err = qpos[:, 2] - height
        return (w_vel * ((vel_err * vel_err).sum(-1) + yaw_rate_err ** 2)
                + w_height * h_err ** 2 + w_upright * up_err ** 2
                + w_ctrl * (ctrl * ctrl).sum(-1))

    return cost


class MPPI:
    """Static config; `solve` rolls out all K samples as one batch."""

    def __init__(self, model: DeviceModel, cost_fn: Callable, config: MPPIConfig = MPPIConfig()):
        self.model = model
        self.cfg = config
        self.cost_fn = cost_fn

    def _rollout_cost(self, qpos, qvel, ctrl_seqs):
        """(K,) total cost of K control sequences ctrl_seqs (K, H, nu), each
        rolled out from the one state qpos (nq,), qvel (nv,)."""
        K = ctrl_seqs.shape[0]
        qp, qv = qpos.expand(K, -1), qvel.expand(K, -1)
        total = 0.0
        for ctrl in ctrl_seqs.unbind(1):
            qp, qv, _ = engine.step_batched(self.model, qp, qv, ctrl,
                                            solver_iterations=self.cfg.solver_iterations)
            total = total + self.cost_fn(qp, qv, ctrl)
        return total

    def solve(self, generator: torch.Generator, qpos, qvel, u_nominal):
        """One MPPI solve from qpos (nq,), qvel (nv,) around the plan
        u_nominal (H, nu), the noise drawn from `generator`. Returns
        (u_new (H, nu), info) with info's best cost and effective sample
        size (0-dim tensors)."""
        cfg = self.cfg
        eps = cfg.sigma * torch.randn((cfg.n_samples, cfg.horizon, self.model.m.nu),
                                      generator=generator, dtype=qpos.dtype, device=qpos.device)
        costs = self._rollout_cost(qpos, qvel, u_nominal[None] + eps)
        return self._update(u_nominal, eps, costs)

    def _update(self, u_nominal, eps, costs):
        beta = costs.amin()
        w = torch.exp(-(costs - beta) / self.cfg.temperature)
        w = w / w.sum()
        u_new = u_nominal + torch.einsum('k,khu->hu', w, eps)
        return u_new, {'best_cost': beta, 'ess': 1.0 / (w * w).sum()}

    def solve_sharded(self, *args, **kwargs):
        """The reference's multi-chip solve (scenarios sharded over a mesh,
        reduced with psum) waits for the port of `parallel/` on
        torch.distributed (ROADMAP Queue 1, item 6)."""
        raise NotImplementedError(
            'MPPI.solve_sharded needs the port of parallel/ on torch.distributed '
            '(ROADMAP Queue 1, item 6: parallel/)')

    @staticmethod
    def shift(u, fill=None):
        """Receding-horizon shift: drop the executed step, repeat the tail."""
        tail = u[-1:] if fill is None else fill[None]
        return torch.cat([u[1:], tail], 0)
