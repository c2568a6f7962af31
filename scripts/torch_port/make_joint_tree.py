"""Build the joint-tree test model and write it to the port's fixtures.

A quadruped with every joint type on one tree, under go2's names (so go2's
robot config reads it): a free base (a box trunk with the `imu` site and the
`imu_acc` / `imu_gyro` sensors); a capsule tail on an unlimited ball joint;
per leg `{leg}_hip_joint` (abduction) and `{leg}_thigh_joint` (flexion), two
limited, damped hinges on the one body `{leg}_hip`, and `{leg}_calf_joint`,
a limited, sprung and damped slide joint (a telescoping shank) ending in the
foot sphere `{leg}`; 12 motors. nq 23, nv 21. The tail is unlimited: the
reference's limit rows read a ball joint's qpos as a scalar, which is not
MuJoCo's ball limit.

The MJCF is compiled with `mujoco`, extracted with the reference's
`models.builder.extract_model` and written with its `Model.save`, so the
archive is the reference's own format; the port reads it with `Model.load`
(no MuJoCo, no JAX).

    python3 scripts/torch_port/make_joint_tree.py
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gym_quadruped_tpu_torch.models.model import JOINT_TREE  # noqa: E402

ROBOT, SCENE = 'go2', 'flat'
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
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" friction="1 0.005 0.0001"/>
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


def mjcf() -> str:
    """The MJCF text of the joint tree."""
    legs = ''.join(LEG.format(leg=leg, x=x, y=y, side=0.03 if y > 0 else -0.03)
                   for leg, (x, y) in LEGS.items())
    motors = '\n'.join(MOTOR.format(leg=leg, part=part, lim=lim) for leg in LEGS
                       for part, lim in (('hip', 23.7), ('thigh', 23.7), ('calf', 100)))
    legs_q = ' '.join('0 0.2 0' for _ in LEGS)
    tail_q = f'{math.cos(TAIL_PITCH / 2):.12f} 0 {math.sin(TAIL_PITCH / 2):.12f} 0'
    return MJCF.format(legs=legs, motors=motors, legs_q=legs_q, tail_q=tail_q)


def mj_model():
    """The compiled mjModel."""
    import mujoco

    return mujoco.MjModel.from_xml_string(mjcf())


def reference_model():
    """The reference's Model of the joint tree (`extract_model`)."""
    from gym_quadruped_tpu.models.builder import extract_model

    return extract_model(mj_model(), ROBOT, SCENE, TERRAIN_LIMITS)


def main():
    m = reference_model()
    JOINT_TREE.parent.mkdir(parents=True, exist_ok=True)
    m.save(JOINT_TREE)
    print(f'{JOINT_TREE}: nq {m.nq}, nv {m.nv}, {m.njnt} joints (types '
          f'{m.jnt_type.tolist()}), {len(m.contact_pairs)} contact pairs, '
          f'{JOINT_TREE.stat().st_size} bytes')


if __name__ == '__main__':
    main()
