"""Start states standing on a scene's world geometry.

The ramp, slippery, stairs and random_pyramids scenes (`models.scenes`)
put their feature away from the origin's keyframe: the ramp is one box
pitched by the quaternion (1, 0, -0.2, 0) (22.6 degrees, its +x end up);
the stairs are 50 boxes from x = 1.1, rising 0.05 every 0.1; the slippery
scene has two priority-2 boxes 1 cm high, friction 0.8 about x = 2 and 0.03
from x = 5 to 31; at seed 10 with go2's hip height the pyramid is 4
axis-aligned tiers 0.107 m high about x = 3, half-widths 1.40, 0.99, 0.58
and 0.17 m. `feature_start` stands a batch of envs on the feature, so that
a step holds the contacts against the world boxes and not the floor's
alone.

    qpos = feature_start(dm, 4096, torch.Generator(dm.device).manual_seed(0))
    touching = (fwd.contacts.dist < incl) & world_box_slots(dm)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import GEOM_BOX, DeviceModel
from gym_quadruped_tpu_torch.physics import collision, kinematics
from gym_quadruped_tpu_torch.physics.constraints import constraint_layout
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask
from gym_quadruped_tpu_torch.utils.maths import quat_mul, quat_to_mat

# rounds of `drop_to_touch`: a foot over a stair's nose first meets its
# edge, whose normal tilts away as the foot sinks past it, so the lowering
# needs a few rounds to reach the tread under another foot
DROP_ROUNDS = 6
# how far the first foot presses into the surface it touches [m]
PRESS = 0.001


def world_box_slots(dm: DeviceModel) -> torch.Tensor:
    """(S,) bool on the model's device: the slot's first geom is a world
    box."""
    m = dm.m
    box = (m.geom_bodyid == 0) & (m.geom_type == GEOM_BOX)
    return dm.const('world_box_slots', lambda: box[constraint_layout(m).con_geom1])


def drop_to_touch(con, slots) -> torch.Tensor:
    """(B,) how far each env's base must move down for its first slot of
    `slots` (S,) bool to touch: the least dist / normal z over those slots
    facing up (normal z > 0.3; side faces are left out)."""
    nz = con.normal[..., 2]
    drop = torch.where(slots & (nz > 0.3), con.dist / nz.clamp_min(0.3), torch.inf)
    return drop.amin(1)


def feature_start(dm: DeviceModel, B: int, generator: torch.Generator) -> torch.Tensor:
    """(B, nq) starts of the robot standing on its scene's feature, on the
    model's device in its dtype: the keyframe turned by the ramp's
    quaternion and set on the ramp's top face 1.0-2.5 m up its slope;
    pitched by the stairs' mean slope (atan 0.5) at x in [1.45, 2.5] (the
    rear feet then over the flight, which starts at 1.05), raised with the
    rise; on the slippery scene the even envs on the 0.8 surface and the odd
    ones on the 0.03 surface (x about 2 and 18); over the pyramid at x in
    [1.7, 4.3], y in [-1.2, 1.2], raised by its top's height. Joints
    U(-0.05, 0.05) off. Then raised 0.3 m clear and lowered, DROP_ROUNDS
    times, until the first foot touches the surface under it and presses
    PRESS on; over the pyramid the first of any robot geom's slots against
    the world (a tail may hang over a higher tier than the feet stand
    on)."""
    m = dm.m
    dev, dtype = dm.device, dm.dtype
    key = torch.as_tensor(m.key_qpos[0], dtype=dtype, device=dev)
    qpos = key.repeat(B, 1)
    u = torch.rand(B, generator=generator, device=dev, dtype=dtype)
    if m.scene == 'ramp':
        g = int(np.flatnonzero((m.geom_bodyid == 0) & (m.geom_type == GEOM_BOX))[0])
        q_box = torch.as_tensor(m.geom_quat[g], dtype=dtype, device=dev)
        local = key[:3] + torch.stack([1.0 + 1.5 * u, torch.zeros_like(u),
                                       torch.full_like(u, float(m.geom_size[g, 2]))], -1)
        qpos[:, :3] = torch.as_tensor(m.geom_pos[g], dtype=dtype, device=dev) \
            + local @ quat_to_mat(q_box).T
        qpos[:, 3:7] = quat_mul(q_box.expand(B, 4), key[3:7].expand(B, 4))
    elif m.scene == 'stairs':
        x = 1.45 + 1.05 * u
        half = 0.5 * math.atan(0.5)
        pitch = torch.tensor([math.cos(half), 0.0, -math.sin(half), 0.0], dtype=dtype, device=dev)
        qpos[:, 0] = x
        qpos[:, 2] += 0.5 * (x - 1.05)
        qpos[:, 3:7] = quat_mul(pitch.expand(B, 4), key[3:7].expand(B, 4))
    elif m.scene == 'slippery':
        qpos[:, 0] = torch.where(torch.arange(B, device=dev) % 2 == 0, 2.0, 18.0) + u - 0.5
    elif m.scene == 'random_pyramids':
        boxes = (m.geom_bodyid == 0) & (m.geom_type == GEOM_BOX)
        qpos[:, 0] = 1.7 + 2.6 * u
        qpos[:, 1] = 2.4 * torch.rand(B, generator=generator, device=dev, dtype=dtype) - 1.2
        qpos[:, 2] += float((m.geom_pos[boxes, 2] + m.geom_size[boxes, 2]).max())
    else:
        raise ValueError(f'no feature start for the scene {m.scene!r}')
    qpos[:, 7:] += 0.1 * torch.rand(B, m.nq - 7, generator=generator, device=dev,
                                    dtype=dtype) - 0.05
    if m.scene == 'random_pyramids':
        lay = constraint_layout(m)
        slots = dm.const('world_slot', lambda: m.geom_bodyid[lay.con_geom1] == 0)
    else:
        slots = dm.const('foot_slot', lambda: np.any(feet_slot_mask(m) > 0, axis=0))
    qpos[:, 2] += 0.3
    for _ in range(DROP_ROUNDS):
        con = collision.collide(dm, kinematics.fk(dm, qpos))
        qpos[:, 2] -= drop_to_touch(con, slots) + PRESS
    return qpos
