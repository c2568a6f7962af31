"""Record a batched dataset, read it back, rebuild the env from the file.

The counterpart of examples/aliengo_dataset.py: `--episodes` envs of
aliengo/flat with random velocity commands run as one batch under seeded
U(-5, 5) torques, and are written as that many episodes with
`H5Writer.append_batch` (the reference's schema); the file's `env_hparams`
then rebuild the env, and `ProprioceptiveDataset` takes a window of it.
The recordings stay on the model's device until the one write. Needs h5py.

    python -m gym_quadruped_tpu_torch.examples.aliengo_dataset [--episodes 4] [--steps 200]
        [--path aliengo_dataset.h5] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from gym_quadruped_tpu_torch.data import ProprioceptiveDataset
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.utils.data import H5Reader, H5Writer

OBS = ('qpos', 'qvel', 'base_lin_vel', 'base_ang_vel', 'feet_pos:base', 'contact_state')


def record(path, episodes: int, steps: int, device='cuda') -> QuadrupedEnv:
    """Write `episodes` episodes of `steps` steps to `path`; returns the env."""
    env = QuadrupedEnv('aliengo', state_obs_names=OBS, scene='flat',
                       base_vel_command_type='random', ref_base_lin_vel=(-1.0, 1.0),
                       model=load_model('aliengo', 'flat', device=device))
    writer = H5Writer(path, env=env)
    dm = env.model
    gen = torch.Generator(device=dm.device).manual_seed(0)
    state, obs = env.reset(gen, episodes)

    traj = {k: [v] for k, v in obs.items()}
    actions = [torch.zeros(episodes, dm.m.nu, dtype=dm.dtype, device=dm.device)]
    times = [state.time]
    # the reference's per-step draws of RandomState(0), in one copy to the device
    torques = torch.as_tensor(np.random.RandomState(0).uniform(
        -5, 5, (steps - 1, episodes, dm.m.nu)), dtype=dm.dtype, device=dm.device)
    for a in torques:
        state, obs, reward, term, trunc, info = env.step(state, a, gen)
        for k, v in obs.items():
            traj[k].append(v)
        actions.append(a)
        times.append(state.time)

    batch = {k: torch.stack(v, dim=1) for k, v in traj.items()}
    batch['action'] = torch.stack(actions, dim=1)
    writer.append_batch(batch, torch.stack(times, dim=1))
    print(f'wrote {episodes} episodes × {steps} steps to {path}')
    return env


def read_back(path, device='cuda'):
    """(the env rebuilt from the file's env_hparams, the dataset)."""
    reader = H5Reader(path)
    hp = reader.env_hparams
    print(f'{reader.n_trajectories} episodes; env_hparams: '
          f'{ {k: v for k, v in hp.items() if k != "state_obs_names"} }')
    reader.close()
    # the env rebuilt from the file (the reference's round trip), its model on `device`
    env2 = QuadrupedEnv(**hp, model=load_model(hp['robot'], hp['scene'], hp['sim_dt'],
                                               device=device))
    print(f'reconstructed env: {env2.robot_name} / {env2.scene_name}')

    dataset = ProprioceptiveDataset(path, x_obs_names=['qpos', 'qvel'],
                                    y_obs_names=['contact_state'], x_frames=10, y_frames=1,
                                    mode='dynamic')
    x, y = dataset[0]
    print(f'{dataset} — x window qpos {np.asarray(x["qpos"]).shape}, '
          f'y {np.asarray(y["contact_state"]).shape}')
    return env2, dataset


def main(episodes: int = 4, steps: int = 200, path=None, device='cuda'):
    """record, then read_back; returns read_back's (env, dataset)."""
    path = path or os.path.join(tempfile.gettempdir(), 'aliengo_dataset.h5')
    record(path, episodes, steps, device)
    return read_back(path, device)


if __name__ == '__main__':
    p = argparse.ArgumentParser(description='record a batched dataset, read it back')
    p.add_argument('--episodes', type=int, default=4)
    p.add_argument('--steps', type=int, default=200)
    p.add_argument('--path', default=None,
                   help='the H5 file (default: aliengo_dataset.h5 in the temporary directory)')
    p.add_argument('--device', default='cuda')
    main(**vars(p.parse_args()))
