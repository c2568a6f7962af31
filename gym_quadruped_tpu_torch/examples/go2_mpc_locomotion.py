"""go2 trots under the centroidal MPC: the port's whole control stack.

The counterpart of examples/go2_mpc_locomotion.py: velocity-command
tracking MPC at H=12 (a replan every 5 steps, 100 Hz, of the 500 Hz
simulation) on the batched physics at B=1, from the keyframe. The tick and
`QuadrupedEnv.step` take any batch unchanged.

The histories of qpos and vx stay on the model's device and come to the
host once, at the end; the line printed every 500 steps reads the state.

    python -m gym_quadruped_tpu_torch.examples.go2_mpc_locomotion [--vx 0.4] [--seconds 3.0]
        [--record trot.h5] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import CentroidalMPC, GaitConfig, MPCConfig
from gym_quadruped_tpu_torch.physics.constraints import _point_jacobians
from gym_quadruped_tpu_torch.physics.kinematics import cdof, fk

REPLAN = 5        # steps between replans: 100 Hz
PRINT_EVERY = 500  # steps between the progress lines: 1 s


def feet_and_jacobians(dm, state):
    """(feet (B, 4, 3) world positions, their world Jacobians (B, 4, 3, nv))."""
    m = dm.m
    kin = fk(dm, state.qpos)
    feet = kin.geom_xpos[:, dm.const('feet_geom_id', lambda: m.feet_geom_id)]
    jacp, _ = _point_jacobians(dm, kin, cdof(dm, kin), feet, m.feet_body_id)
    return feet, jacp


def tick(mpc, state, ref, warm):
    """(tau (B, nu), warm start) of one replan: the feet and their world
    Jacobians, one solve (cold where `warm` is None, else warm-started from
    the previous replan's), the torques of its first knot."""
    feet, jacp = feet_and_jacobians(mpc.model, state)
    forces, warm = mpc.solve(state.qpos, state.qvel, feet, state.time, ref,
                             torch.zeros_like(state.time), warmstart=warm)
    return mpc.torques(state.qpos, state.qvel, feet, jacp, forces[:, 0], state.time, ref), warm


def synchronize(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def main(vx: float = 0.4, seconds: float = 3.0, record: str | None = None,
         device='cuda') -> dict:
    """Trot for `seconds` at `vx` m/s; with `record`, write the qpos history
    to that H5 file. Returns the env, the last state, torques and warm
    start, the host histories ('qpos' (T, nq), 'vx' (T,)), the last
    observations, the wall seconds and the counts of steps and solves."""
    dm = load_model('go2', 'flat', device=device)
    env = QuadrupedEnv('go2', state_obs_names=('qpos', 'qvel', 'contact_state'), scene='flat',
                       base_vel_command_type='forward', ref_base_lin_vel=vx, model=dm)
    m = dm.m
    mpc = CentroidalMPC(dm, MPCConfig(gait=GaitConfig('trot', period=0.5), iterations=50))
    ref = torch.tensor([[vx, 0.0, 0.0]], dtype=dm.dtype, device=dm.device)
    state, obs = env.reset(torch.Generator(device=dm.device).manual_seed(0), 1,
                           qpos=m.key_qpos[:1], qvel=np.zeros((1, m.nv)))

    n_steps = int(seconds / m.timestep)
    tau, warm = tick(mpc, state, ref, None)   # the cold solve; each replan is warm after it
    qpos_hist = torch.empty(n_steps, m.nq, dtype=dm.dtype, device=dm.device)
    vxs = torch.empty(n_steps, dtype=dm.dtype, device=dm.device)
    synchronize(dm.device)
    t0 = time.time()
    for i in range(n_steps):
        if i % REPLAN == 0:
            tau, warm = tick(mpc, state, ref, warm)
        state, obs, reward, term, trunc, info = env.step(state, tau)
        qpos_hist[i] = state.qpos[0]
        vxs[i] = state.qvel[0, 0]
        if (i + 1) % PRINT_EVERY == 0:
            print(f't={float(state.time[0]):.2f}s  z={float(state.qpos[0, 2]):.3f}  '
                  f'vx(last s)={float(vxs[i + 1 - PRINT_EVERY:i + 1].mean()):.3f}  '
                  f'contacts={obs["contact_state"][0].cpu().numpy()}')
    synchronize(dm.device)
    wall = time.time() - t0
    solves = n_steps // REPLAN
    print(f'{n_steps} steps + {solves} MPC solves in {wall:.1f}s wall')
    qpos_np, vx_np = qpos_hist.cpu().numpy(), vxs.cpu().numpy()

    if record:
        from gym_quadruped_tpu_torch.utils.data import H5Writer

        w = H5Writer(record, obs_dims={'qpos': m.nq}, action_dim=m.nu,
                     env_hparams=env.get_hyperparameters())
        w.append_trajectory({'qpos': qpos_np}, np.arange(n_steps)[:, None] * m.timestep)
        print(f'recorded to {record} — replay with '
              f'gym_quadruped_tpu_torch.utils.replay.replay_h5')
    return {'env': env, 'mpc': mpc, 'state': state, 'tau': tau, 'warm': warm, 'obs': obs,
            'qpos': qpos_np, 'vx': vx_np, 'wall': wall, 'steps': n_steps, 'solves': solves}


if __name__ == '__main__':
    p = argparse.ArgumentParser(description='go2 trots under the centroidal MPC')
    p.add_argument('--vx', type=float, default=0.4)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--record', default=None)
    p.add_argument('--device', default='cuda')
    main(**vars(p.parse_args()))
