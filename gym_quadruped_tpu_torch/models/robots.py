"""Robot registry: per robot its MJCF file, nominal hip height, optional
joint-space zero pose, foot geom names, per-leg joint names and IMU sensor
names (the reference's robot_cfgs.py:7-60).

The port's own copy of gym_quadruped_tpu/models/robots.py, numpy only. The
step reads compiled model archives; `find_assets_dir` locates the robot MJCF
files that `models.builder` compiles them from.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

LEG_ORDER = ('FL', 'FR', 'RL', 'RR')  # canonical leg order


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    name: str
    mjcf_filename: str
    hip_height: float
    qpos0_js: tuple | None = None
    feet_geom_names: tuple[str, str, str, str] = ('FL', 'FR', 'RL', 'RR')  # FL FR RL RR
    leg_joints: tuple[tuple[str, ...], ...] | None = None  # per leg, FL FR RL RR
    accel_name: str | None = 'imu_acc'
    gyro_name: str | None = 'imu_gyro'
    imu_site_name: str | None = 'imu'

    def leg_joint_names(self) -> tuple[tuple[str, ...], ...]:
        if self.leg_joints is not None:
            return self.leg_joints
        return tuple(
            tuple(f'{leg}_{part}_joint' for part in ('hip', 'thigh', 'calf'))
            for leg in LEG_ORDER
        )


_REGISTRY: dict[str, RobotConfig] = {cfg.name: cfg for cfg in (
    RobotConfig(name='mini_cheetah', mjcf_filename='mini_cheetah/mini_cheetah.xml',
                hip_height=0.225,
                qpos0_js=tuple([0, -np.pi / 2, 0] * 2 + [0, np.pi / 2, 0] * 2)),
    RobotConfig(name='go1', mjcf_filename='go1/go1.xml', hip_height=0.3),
    RobotConfig(name='go2', mjcf_filename='go2/go2.xml', hip_height=0.28),
    RobotConfig(name='aliengo', mjcf_filename='aliengo/aliengo.xml', hip_height=0.35),
    RobotConfig(name='b2', mjcf_filename='b2/b2.xml', hip_height=0.485),
    RobotConfig(name='hyqreal1', mjcf_filename='hyqreal1/hyqreal1.xml', hip_height=0.498),
    RobotConfig(name='hyqreal2', mjcf_filename='hyqreal2/hyqreal2.xml', hip_height=0.498),
    RobotConfig(name='spot', mjcf_filename='spot/spot.xml', hip_height=0.46),
    RobotConfig(name='pegasus', mjcf_filename='pegasus/pegasus.xml', hip_height=0.5),
)}


def get_robot_config(robot_name: str) -> RobotConfig:
    """Name lookup with the reference's fuzzy matching (robot_cfgs.py:31-60)."""
    name = robot_name.lower()
    if name in _REGISTRY:
        return _REGISTRY[name]
    for key in ('mini_cheetah', 'hyqreal1', 'hyqreal2', 'spot'):
        if key in name:
            return _REGISTRY[key]
    raise ValueError(f'Unknown robot name: {robot_name}. Available: {sorted(_REGISTRY)}')


def available_robots() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def find_assets_dir() -> Path | None:
    """A directory of robot MJCF assets in the robot_model layout
    (`<dir>/<robot>/<robot>.xml`, as `RobotConfig.mjcf_filename` names them).

    Search order: $GYM_QUADRUPED_ASSETS, the assets vendored in this package
    (gym_quadruped_tpu_torch/assets/robot_model), an installed `gym_quadruped`
    package's robot_model. None when there are none (the compiled archives
    still load)."""
    env = os.environ.get('GYM_QUADRUPED_ASSETS')
    if env and Path(env).exists():
        return Path(env)
    vendored = Path(__file__).resolve().parent.parent / 'assets' / 'robot_model'
    if vendored.exists():
        return vendored
    try:
        import gym_quadruped  # type: ignore
    except ImportError:
        return None
    cand = Path(gym_quadruped.__file__).parent / 'robot_model'
    return cand if cand.exists() else None
