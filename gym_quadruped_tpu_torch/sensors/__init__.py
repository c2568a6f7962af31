"""Sensors (IMU, heightmap, depth camera) on the batched sensor protocol."""

from gym_quadruped_tpu_torch.sensors.base import Sensor
from gym_quadruped_tpu_torch.sensors.heightmap import HeightMap, HeightMapState
from gym_quadruped_tpu_torch.sensors.imu import IMU, IMUState
from gym_quadruped_tpu_torch.sensors.rgbd_camera import Camera, CameraState

__all__ = ['Sensor', 'IMU', 'IMUState', 'HeightMap', 'HeightMapState',
           'Camera', 'CameraState']
