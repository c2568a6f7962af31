"""Record a trajectory dataset, rebuild the env from it, replay it.

The counterpart of examples/dataset_reproduction.py: go2/flat trots under
the centroidal MPC (a cold solve every 5 steps) and the trajectory is
written to H5; the env is rebuilt from the file's `env_hparams`, the
recorded qpos replayed offscreen with `utils.replay.render_video` (which
needs `mujoco`, go2's MJCF and a GL backend: where any is missing, a line
says so), with morpho_symm installed the observables' symmetry
representations and augmented copies, and the windows' moments through
`ProprioceptiveDataset`. Needs h5py.

    python -m gym_quadruped_tpu_torch.examples.dataset_reproduction [--steps 300]
        [--path go2_trot_dataset.h5] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from gym_quadruped_tpu_torch.data import ProprioceptiveDataset
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.examples.go2_mpc_locomotion import REPLAN, tick
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import CentroidalMPC, GaitConfig, MPCConfig
from gym_quadruped_tpu_torch.utils.data import H5Reader, H5Writer

OBS = ('qpos', 'qvel', 'base_lin_vel', 'contact_state')
VX = 0.4


def record(path, steps: int, device='cuda') -> QuadrupedEnv:
    """Write `steps` steps of an MPC trot as one episode to `path`; returns
    the env."""
    dm = load_model('go2', 'flat', device=device)
    env = QuadrupedEnv('go2', state_obs_names=OBS, scene='flat',
                       base_vel_command_type='forward', ref_base_lin_vel=VX, model=dm)
    writer = H5Writer(path, env=env)
    m = dm.m
    state, obs = env.reset(torch.Generator(device=dm.device).manual_seed(0), 1,
                           qpos=m.key_qpos[:1], qvel=np.zeros((1, m.nv)))
    mpc = CentroidalMPC(dm, MPCConfig(gait=GaitConfig('trot'), iterations=50))
    ref = torch.tensor([[VX, 0.0, 0.0]], dtype=dm.dtype, device=dm.device)

    traj = {k: [v[0]] for k, v in obs.items()}
    actions = [torch.zeros(m.nu, dtype=dm.dtype, device=dm.device)]
    times = [torch.zeros((), dtype=dm.dtype, device=dm.device)]
    tau, _ = tick(mpc, state, ref, None)
    for i in range(steps - 1):
        if i % REPLAN == 0:
            tau, _ = tick(mpc, state, ref, None)   # a cold solve at every replan
        state, obs, *_ = env.step(state, tau)
        for k, v in obs.items():
            traj[k].append(v[0])
        actions.append(tau[0])
        times.append(state.time[0])

    writer.append_trajectory({**{k: torch.stack(v) for k, v in traj.items()},
                              'action': torch.stack(actions)}, torch.stack(times)[:, None])
    print(f'recorded {steps} steps of MPC trot to {path}')
    return env


def reproduce(path, device='cuda'):
    """(the env rebuilt from the file, the dataset with its moments)."""
    reader = H5Reader(path)
    hp = reader.env_hparams
    # the env rebuilt from the file (the reference's round trip), its model on `device`
    env2 = QuadrupedEnv(**hp, model=load_model(hp['robot'], hp['scene'], hp['sim_dt'],
                                               device=device))
    print(f'reconstructed env from file: {env2.robot_name}/{env2.scene_name}')
    _, traj = reader.get_trajectory(0)
    qpos_traj = traj['qpos']

    # the replay, offscreen
    try:
        from gym_quadruped_tpu_torch.utils.replay import render_video

        out = render_video(qpos_traj, 'go2', 'flat', fps=25,
                           out_path=os.path.join(tempfile.gettempdir(), 'replay.mp4'))
        what = out if isinstance(out, str) else f'{len(out)} frames'
        print(f'replay rendered: {what}')
    except Exception as e:  # no mujoco, no MJCF or no GL here
        print(f'replay rendering unavailable here ({type(e).__name__}); '
              f'use utils.replay.replay_interactive on a machine with a display')

    # the symmetry representations (the morpho_symm extra)
    try:
        from gym_quadruped_tpu_torch.utils.symmetry import (
            augment_obs_data,
            configure_observation_space_representations,
        )

        reps = configure_observation_space_representations('go2', list(OBS))
        print('symmetry reps:', {k: getattr(v, 'name', v) for k, v in reps.items()})
        # data augmentation (reference dataset_reproduction.py:26-58): every
        # recorded observable mapped through each group element
        obs_data = {name: np.asarray(reader.recordings[name][0]) for name in OBS}
        G_obs = augment_obs_data(obs_data, reps)
        n_aug = sum(1 for g, v in G_obs[OBS[0]].items() if v is not None)
        print(f'augmented dataset: {n_aug} symmetric copies per trajectory '
              f'({", ".join(OBS)})')
    except ImportError:
        print('morpho_symm not installed — skipping symmetry augmentation')
    reader.close()

    dataset = ProprioceptiveDataset(path, x_obs_names=['qpos', 'qvel'],
                                    y_obs_names=['contact_state'], x_frames=10, y_frames=2,
                                    mode='dynamic')
    dataset.compute_obs_moments()
    x, y = dataset[0]
    print(f'{dataset}; qvel moments mean[:3] = '
          f'{np.asarray(dataset.mean_vars["qvel"][0][:3]).round(3)}')
    return env2, dataset


def main(steps: int = 300, path=None, device='cuda'):
    """record, then reproduce; returns reproduce's (env, dataset)."""
    path = path or os.path.join(tempfile.gettempdir(), 'go2_trot_dataset.h5')
    record(path, steps, device)
    return reproduce(path, device)


if __name__ == '__main__':
    p = argparse.ArgumentParser(description='record, rebuild the env, replay')
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--path', default=None,
                   help='the H5 file (default: go2_trot_dataset.h5 in the temporary directory)')
    p.add_argument('--device', default='cuda')
    main(**vars(p.parse_args()))
