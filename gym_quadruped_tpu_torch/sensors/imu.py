"""IMU sensor: the site-frame accelerometer and gyroscope with noise and bias
drift.

Counterpart of gym_quadruped_tpu/sensors/imu.py (the reference's IMU,
imu.py:20-254, which reads MuJoCo's <accelerometer>/<gyro> sensordata and
adds Gaussian noise and a Brownian bias). The true readings come from the
step's Forward at the PRE-step state: the accelerometer is the linear
acceleration of the IMU site in the site frame with the gravity offset
(MuJoCo's mj_sensorAcc: +9.81 z at rest), the gyro the body's angular
velocity in the site frame. The noise and the bias steps are drawn from the
generator the caller passes; a noisy IMU stepped without one raises.
"""

from __future__ import annotations

import dataclasses

import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.physics import dynamics
from gym_quadruped_tpu_torch.physics.kinematics import spatial_origin
from gym_quadruped_tpu_torch.sensors.base import Sensor

LIN_ACC_OBS = ('imu_acc', 'imu_acc_noise', 'imu_acc_bias')
GYRO_OBS = ('imu_gyro', 'imu_gyro_noise', 'imu_gyro_bias')


@dataclasses.dataclass
class IMUState:
    acc: torch.Tensor         # (B, 3) last accelerometer measurement
    acc_noise: torch.Tensor   # (B, 3)
    acc_bias: torch.Tensor    # (B, 3) Brownian bias
    gyro: torch.Tensor        # (B, 3)
    gyro_noise: torch.Tensor  # (B, 3)
    gyro_bias: torch.Tensor   # (B, 3)


class IMU(Sensor):
    """See the module docstring. The constructor mirrors the reference's
    (imu.py:25-48)."""

    ALL_OBS = LIN_ACC_OBS + GYRO_OBS

    def __init__(self, model: DeviceModel, imu_site_name: str | None = None,
                 accel_name: str = 'imu_acc', gyro_name: str = 'imu_gyro',
                 accel_noise: float = 0.01, gyro_noise: float = 0.01,
                 accel_bias_rate: float = 0.01, gyro_bias_rate: float = 0.01):
        self.model = model
        del accel_name, gyro_name  # the readings come from the dynamics, not sensordata
        m = model.m
        self.site_id = (m.name2id('site', imu_site_name) if imu_site_name is not None
                        else int(m.imu_site_id))
        if self.site_id < 0:
            raise ValueError('model has no IMU site')
        self.body_id = int(m.site_bodyid[self.site_id])
        self.acc_noise = accel_noise
        self.gyro_noise = gyro_noise
        self.acc_bias_rate = accel_bias_rate
        self.gyro_bias_rate = gyro_bias_rate

    @property
    def noisy(self) -> bool:
        return max(self.acc_noise, self.gyro_noise, self.acc_bias_rate,
                   self.gyro_bias_rate) > 0

    def available_observations(self):
        return IMU.ALL_OBS

    def observation_dim(self, name):
        return 3

    def init(self, generator, B):
        dm = self.model
        z = torch.zeros(B, 3, dtype=dm.dtype, device=dm.device)
        nan = torch.full((B, 3), float('nan'), dtype=dm.dtype, device=dm.device)
        return IMUState(acc=nan, acc_noise=z, acc_bias=z, gyro=nan.clone(),
                        gyro_noise=z.clone(), gyro_bias=z.clone())

    def truth(self, qvel: torch.Tensor, fwd) -> tuple:
        """(acc (B, 3), gyro (B, 3)) without noise, from the Forward `fwd`
        at the state whose velocity is qvel (imu.py:83-96)."""
        dm = self.model
        kin = fwd.kin
        R_site = kin.site_xmat[:, self.site_id]                       # (B, 3, 3)
        p_site = kin.site_xpos[:, self.site_id] - spatial_origin(kin)
        V = dynamics.body_velocities(dm, kin, qvel, fwd.cdof)[:, self.body_id]
        A = dynamics.body_accelerations(dm, kin, qvel, fwd.qacc, fwd.cdof)[:, self.body_id]
        omega, v0 = V[:, :3], V[:, 3:]
        alpha, a0 = A[:, :3], A[:, 3:]
        v_p = v0 + torch.linalg.cross(omega, p_site)
        a_p = a0 + torch.linalg.cross(alpha, p_site) + torch.linalg.cross(omega, v_p)
        site = lambda v: (v[:, :, None] * R_site).sum(1)              # R_site^T v
        return site(a_p), site(omega)

    def measure(self, ss: IMUState, acc_true, gyro_true, z: torch.Tensor) -> IMUState:
        """The state after one reading: z (B, 4, 3) are standard normal draws
        for the accelerometer's noise and bias step, then the gyro's
        (imu.py:98-110; a bias step of dt = 1, as upstream)."""
        acc_noise = self.acc_noise * z[:, 0]
        acc_bias = ss.acc_bias + self.acc_bias_rate * z[:, 1]
        gyro_noise = self.gyro_noise * z[:, 2]
        gyro_bias = ss.gyro_bias + self.gyro_bias_rate * z[:, 3]
        return IMUState(acc=acc_true + acc_bias + acc_noise, acc_noise=acc_noise,
                        acc_bias=acc_bias, gyro=gyro_true + gyro_bias + gyro_noise,
                        gyro_noise=gyro_noise, gyro_bias=gyro_bias)

    def step(self, ss: IMUState, qpos, qvel, fwd, generator=None) -> IMUState:
        acc, gyro = self.truth(qvel, fwd)
        B = qvel.shape[0]
        if self.noisy:
            if generator is None:
                raise ValueError('the IMU draws noise and bias steps: pass a generator')
            z = torch.randn(B, 4, 3, generator=generator, dtype=qvel.dtype, device=qvel.device)
        else:
            z = qvel.new_zeros(B, 4, 3)
        return self.measure(ss, acc, gyro, z)

    def get_observation(self, name, ss: IMUState):
        return {'imu_acc': ss.acc, 'imu_acc_noise': ss.acc_noise,
                'imu_acc_bias': ss.acc_bias, 'imu_gyro': ss.gyro,
                'imu_gyro_noise': ss.gyro_noise, 'imu_gyro_bias': ss.gyro_bias}[name]
