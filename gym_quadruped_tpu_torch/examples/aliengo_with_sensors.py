"""IMU, heightmap and depth camera on aliengo/perlin.

The counterpart of examples/aliengo_with_sensors.py: the IMU (noise 0.01)
and a 10 x 10 HeightMap of 0.1 m ride in the env's state; after a random
reset and 20 steps of zero torque, the `robotcam` depth camera renders the
state at 64 x 48 through `Camera.shoot`.

    python -m gym_quadruped_tpu_torch.examples.aliengo_with_sensors [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.sensors import IMU, Camera, HeightMap

STEPS = 20


def main(device='cuda') -> dict:
    """Returns the last state and observations and the camera's images of
    the state ('depth', 'depth_plane', 'seg' (H, W), 'cloud' (H*W, 3))."""
    dm = load_model('aliengo', 'perlin', device=device)
    env = QuadrupedEnv(
        'aliengo',
        state_obs_names=('qpos', 'qvel', 'imu_acc', 'imu_gyro', 'imu_acc_bias',
                         'height_map_z'),
        scene='perlin',
        sensors=(IMU, HeightMap),
        sensors_kwargs=({'accel_noise': 0.01, 'gyro_noise': 0.01},
                        {'num_rows': 10, 'num_cols': 10, 'dist_x': 0.1, 'dist_y': 0.1}),
        model=dm,
    )
    gen = torch.Generator(device=dm.device).manual_seed(0)
    state, obs = env.reset(gen, 1)
    tau = torch.zeros(1, dm.m.nu, dtype=dm.dtype, device=dm.device)
    for _ in range(STEPS):
        state, obs, reward, term, trunc, info = env.step(state, tau, gen)

    host = {name: obs[name][0].cpu().numpy() for name in ('imu_acc', 'imu_gyro', 'height_map_z')}
    print('imu_acc      ', host['imu_acc'].round(3))
    print('imu_gyro     ', host['imu_gyro'].round(3))
    print('height_map_z ', host['height_map_z'].reshape(10, 10)[::3, ::3])

    # the depth camera, driven by hand (aliengo carries a 'robotcam' camera)
    cam = Camera(dm, width=64, height=48, cam_name='robotcam')
    depth, depth_plane, seg, cloud = (x[0] for x in cam.shoot(state.qpos))
    print('depth image  ', tuple(depth.shape),
          'range [%.2f, %.2f]' % (float(depth.min()), float(depth.max())))
    print('seg ids      ', np.unique(seg.cpu().numpy())[:10])
    return {'env': env, 'state': state, 'obs': obs, 'depth': depth,
            'depth_plane': depth_plane, 'seg': seg, 'cloud': cloud}


if __name__ == '__main__':
    p = argparse.ArgumentParser(description='IMU, heightmap and depth camera on aliengo/perlin')
    p.add_argument('--device', default='cuda')
    main(**vars(p.parse_args()))
