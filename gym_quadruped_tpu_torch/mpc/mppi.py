"""Sampling-based MPC (MPPI) over the full contact physics.

Counterpart of gym_quadruped_tpu/mpc/mppi.py: Model-Predictive Path
Integral control where every candidate control sequence is rolled out
through the real batched engine (not the SRB approximation), so the planner
sees contacts, joint limits and actuator saturation exactly. The K rollouts
are the batch of one `engine.step_batched` call per horizon step, at the
config's Newton cap and without a warm start (the reference's `engine.step`
inside `lax.scan`), so each horizon step launches the port's kernels once.
`solve_sharded` splits the K samples over the ranks of torch.distributed
(`parallel/`) and reduces with all-reduces.

    u*_t = sum_k w_k (u_t + eps_k,t),   w_k ~ exp(-cost_k / lambda)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as tdist

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


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s noise in a sharded solve seeded `seed`:
    `seed` itself on rank 0, the ranks apart by a golden-ratio stride."""
    return (int(seed) + int(rank) * 0x9E3779B97F4A7C15) % 2**63


def _all_reduce(x, op):
    """x reduced over every rank (a new tensor)."""
    x = x.clone()
    tdist.all_reduce(x, op)
    return x


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

    def solve_sharded(self, mesh, seed: int, qpos, qvel, u_nominal):
        """The solve with the K samples split over the mesh's ranks (the
        reference's shard_map solve): each rank rolls out K / world samples
        drawn from a generator on its device seeded by `rank_seed(seed,
        rank)` (the reference folds the axis index into its key), then the
        best cost is an all-reduce MIN and the weights' normaliser, the
        plan update and the sum of squared weights are all-reduce SUMs.
        Every rank returns the same (u_new (H, nu), info). At world size 1
        this is `solve` with `torch.Generator(device).manual_seed(seed)`."""
        cfg = self.cfg
        if cfg.n_samples % mesh.size:
            raise ValueError(f'{cfg.n_samples} samples do not split over {mesh.size} ranks')
        gen = torch.Generator(device=qpos.device).manual_seed(rank_seed(seed, mesh.rank))
        eps = cfg.sigma * torch.randn((cfg.n_samples // mesh.size, cfg.horizon, self.model.m.nu),
                                      generator=gen, dtype=qpos.dtype, device=qpos.device)
        costs = self._rollout_cost(qpos, qvel, u_nominal[None] + eps)
        reduce = _all_reduce if tdist.is_initialized() else (lambda x, op: x)
        beta = reduce(costs.amin(), tdist.ReduceOp.MIN)
        w = torch.exp(-(costs - beta) / cfg.temperature)
        w = w / reduce(w.sum(), tdist.ReduceOp.SUM)
        u_new = u_nominal + reduce(torch.einsum('k,khu->hu', w, eps), tdist.ReduceOp.SUM)
        return u_new, {'best_cost': beta, 'ess': 1.0 / reduce((w * w).sum(), tdist.ReduceOp.SUM)}

    @staticmethod
    def shift(u, fill=None):
        """Receding-horizon shift: drop the executed step, repeat the tail."""
        tail = u[-1:] if fill is None else fill[None]
        return torch.cat([u[1:], tail], 0)
