"""Build the joint-tree test models and write them to the port's fixtures.

A quadruped with every joint type on one tree, under go2's names (so go2's
robot config reads it): a free base (a box trunk with the `imu` site and the
`imu_acc` / `imu_gyro` sensors); a capsule tail on an unlimited ball joint;
per leg `{leg}_hip_joint` (abduction) and `{leg}_thigh_joint` (flexion), two
limited, damped hinges on the one body `{leg}_hip`, and `{leg}_calf_joint`,
a limited, sprung and damped slide joint (a telescoping shank) ending in the
foot sphere `{leg}`; 12 motors. nq 23, nv 21. The tail is unlimited: the
reference's limit rows read a ball joint's qpos as a scalar, which is not
MuJoCo's ball limit.

Two archives, both made with the port's `models.builder` and written with
`Model.save` (the JAX package's format; `Model.load` reads it, with no
MuJoCo):
* `jointtree-flat.npz`: the MJCF with its own floor, compiled with `mujoco`
  and copied by `extract_model`;
* `jointtree-random_pyramids.npz`: the MJCF without the floor, written as
  go2's robot file into a robot_model layout (`write_robot_assets`), and
  compiled on the random_pyramids scene at seed 10 by `build_model`, as a
  user compiles their own robot: 4 axis-aligned tiers about x = 3.

    python3 scripts/torch_port/make_joint_tree.py
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gym_quadruped_tpu_torch.models import builder  # noqa: E402
from gym_quadruped_tpu_torch.models.model import JOINT_TREE, JOINT_TREE_PYRAMIDS  # noqa: E402
from gym_quadruped_tpu_torch.models.robots import get_robot_config  # noqa: E402

ROBOT, SCENE = 'go2', 'flat'
# the procedural scene of the second archive, at `build_model`'s default seed
PYRAMIDS = 'random_pyramids'
# (x_max, x_min, y_max, y_min): random resets spawn within 10 m of the origin
TERRAIN_LIMITS = (10.0, -10.0, 10.0, -10.0)

# the keyframe's tail pitch (rad): it hangs back towards the floor, its tip
# ~5 mm above it, as the feet are
TAIL_PITCH = -1.26
# per leg: the hip's position on the trunk
LEGS = {'FL': (0.19, 0.05), 'FR': (0.19, -0.05), 'RL': (-0.19, 0.05), 'RR': (-0.19, -0.05)}

LEG = """
    <body name="{leg}_hip" pos="{x} {y} 0">
      <joint name="{leg}_hip_joint" type="hinge" axis="1 0 0" range="-0.8 0.8"
             damping="0.1" armature="0.01" frictionloss="0.05"/>
      <joint name="{leg}_thigh_joint" type="hinge" axis="0 1 0" pos="0 {side} 0"
             range="-1.5 1.5" damping="0.1" armature="0.01"/>
      <inertial pos="0 {side} -0.06" mass="1.0" diaginertia="0.004 0.0045 0.001"/>
      <geom type="capsule" fromto="0 {side} 0 0 {side} -0.14" size="0.022"
            contype="0" conaffinity="0"/>
      <body name="{leg}_calf" pos="0 {side} -0.14">
        <joint name="{leg}_calf_joint" type="slide" axis="0 0 1" range="-0.04 0.04"
               stiffness="2000" damping="20" armature="0.02"/>
        <inertial pos="0 0 -0.07" mass="0.25" diaginertia="0.0012 0.0012 0.0001"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.13" size="0.015" contype="0"
              conaffinity="0"/>
        <geom name="{leg}" type="sphere" pos="0 0 -0.13" size="0.022" condim="3"
              priority="1" friction="0.8 0.005 0.0001"/>
      </body>
    </body>"""

MJCF = """
<mujoco model="jointtree">
  <option timestep="0.002" cone="elliptic" impratio="100"/>
  <worldbody>{floor}
    <body name="base" pos="0 0 0.3">
      <freejoint/>
      <inertial pos="0.01 0 0" mass="7.0" diaginertia="0.03 0.09 0.1"/>
      <geom type="box" size="0.2 0.08 0.05" contype="0" conaffinity="0"/>
      <site name="imu" pos="-0.02 0 0.01"/>
{legs}
      <body name="tail" pos="-0.21 0 0.03">
        <joint name="tail_joint" type="ball" damping="0.02" armature="0.002"/>
        <inertial pos="-0.16 0 0.04" mass="0.3" diaginertia="0.0003 0.002 0.002"/>
        <geom name="tail" type="capsule" fromto="0 0 0 -0.32 0 0.08" size="0.015"/>
      </body>
    </body>
  </worldbody>
  <actuator>
{motors}
  </actuator>
  <sensor>
    <accelerometer name="imu_acc" site="imu"/>
    <gyro name="imu_gyro" site="imu"/>
  </sensor>
  <keyframe>
    <key name="home" qpos="0 0 0.27 1 0 0 0 {legs_q} {tail_q}"/>
  </keyframe>
</mujoco>
"""

MOTOR = ('    <motor name="{leg}_{part}" joint="{leg}_{part}_joint" ctrlrange="-{lim} {lim}"'
         ' ctrllimited="true"/>')


FLOOR = '\n    <geom name="floor" type="plane" size="0 0 0.05" friction="1 0.005 0.0001"/>'


def mjcf(floor: bool = True) -> str:
    """The MJCF text of the joint tree; floor=False leaves out its floor, as a
    robot's own MJCF does (the scene brings the floor)."""
    legs = ''.join(LEG.format(leg=leg, x=x, y=y, side=0.03 if y > 0 else -0.03)
                   for leg, (x, y) in LEGS.items())
    motors = '\n'.join(MOTOR.format(leg=leg, part=part, lim=lim) for leg in LEGS
                       for part, lim in (('hip', 23.7), ('thigh', 23.7), ('calf', 100)))
    legs_q = ' '.join('0 0.2 0' for _ in LEGS)
    tail_q = f'{math.cos(TAIL_PITCH / 2):.12f} 0 {math.sin(TAIL_PITCH / 2):.12f} 0'
    return MJCF.format(floor=FLOOR if floor else '', legs=legs, motors=motors,
                       legs_q=legs_q, tail_q=tail_q)


def mj_model():
    """The compiled mjModel."""
    import mujoco

    return mujoco.MjModel.from_xml_string(mjcf())


def write_robot_assets(assets_dir) -> Path:
    """Write the tree's MJCF without its floor as go2's robot file under
    `assets_dir` (`<assets_dir>/go2/go2.xml`, the robot_model layout that
    `robots.find_assets_dir` finds through $GYM_QUADRUPED_ASSETS); returns
    its path."""
    path = Path(assets_dir) / get_robot_config(ROBOT).mjcf_filename
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(mjcf(floor=False))
    return path


def flat_model():
    """The port's Model of the tree on its own floor (`extract_model`)."""
    return builder.extract_model(mj_model(), ROBOT, SCENE, TERRAIN_LIMITS)


def main():
    models = {JOINT_TREE: flat_model()}
    with tempfile.TemporaryDirectory() as assets:
        write_robot_assets(assets)
        os.environ['GYM_QUADRUPED_ASSETS'] = assets
        models[JOINT_TREE_PYRAMIDS] = builder.build_model(ROBOT, PYRAMIDS)
    for path, m in models.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        m.save(path)
        print(f'{path}: nq {m.nq}, nv {m.nv}, {m.njnt} joints (types '
              f'{m.jnt_type.tolist()}), {len(m.contact_pairs)} contact pairs, '
              f'{path.stat().st_size} bytes')


if __name__ == '__main__':
    main()
