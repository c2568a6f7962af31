"""HeightMap sensor: a robot-centred elevation grid by straight-down rays.

Counterpart of gym_quadruped_tpu/sensors/heightmap.py (the reference's
HeightMap, heightmap.py:17-220): a rows x cols grid of points in the
yaw-aligned frame centred above the base, each cast straight down against
the static world from the base's z + 0.6 - 0.07, for every env in one
`raycast_down`. A cell whose ray misses keeps its last hit.

Observables:
  height_map     (rows*cols*3,) world-frame hit points, row-major
  height_map_z   (rows*cols,) their heights
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.physics.raycast import raycast_down
from gym_quadruped_tpu_torch.sensors.base import Sensor
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz


@dataclasses.dataclass
class HeightMapState:
    points: torch.Tensor  # (B, rows, cols, 3) world hit points


class HeightMap(Sensor):
    """See the module docstring. The constructor mirrors the reference's
    (heightmap.py:20-46)."""

    def __init__(self, model: DeviceModel, num_rows: int = 10, num_cols: int = 10,
                 dist_x: float = 0.1, dist_y: float = 0.1):
        self.model = model
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.dist_x = dist_x
        self.dist_y = dist_y
        # grid offsets in the yaw frame, centred by the reference's rules for
        # even and odd sizes (create_sensor_matrix, heightmap.py:115-127)
        r, c = num_rows, num_cols
        c_rows = r / 2.0 if r % 2 == 0 else (r - 1) / 2.0
        off_r = -dist_x / 2.0 if r % 2 == 0 else 0.0
        c_cols = c / 2.0 if c % 2 == 0 else (c - 1) / 2.0
        off_c = -dist_y / 2.0 if c % 2 == 0 else 0.0
        i = np.arange(r)[:, None]
        j = np.arange(c)[None, :]
        self._offsets = np.stack(
            [np.broadcast_to(dist_x * (c_rows - i) + off_r, (r, c)),
             np.broadcast_to(dist_y * (c_cols - j) + off_c, (r, c))], axis=-1)  # (rows, cols, 2)

    def available_observations(self):
        return ('height_map', 'height_map_z')

    def observation_dim(self, name):
        n = self.num_rows * self.num_cols
        return n * 3 if name == 'height_map' else n

    def init(self, generator, B):
        dm = self.model
        return HeightMapState(points=torch.zeros(B, self.num_rows, self.num_cols, 3,
                                                 dtype=dm.dtype, device=dm.device))

    def grid_points(self, qpos: torch.Tensor) -> torch.Tensor:
        """(B, rows, cols, 3) ray origins for base poses qpos (B, nq), at the
        base's z + 0.6 - 0.07 (heightmap.py:79,111,161)."""
        yaw = quat_to_euler_xyz(qpos[:, 3:7])[:, 2]
        cy, sy = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
        off = self.model.const(('heightmap_offsets', self.num_rows, self.num_cols,
                                self.dist_x, self.dist_y), lambda: self._offsets)
        # the reference rotates by R^T of its row-major [cos, sin; -sin, cos]
        x = qpos[:, 0, None, None] + (cy * off[..., 0] - sy * off[..., 1])
        y = qpos[:, 1, None, None] + (sy * off[..., 0] + cy * off[..., 1])
        z = (qpos[:, 2, None, None] + 0.6 - 0.07).expand_as(x)
        return torch.stack([x, y, z], -1)

    def update(self, ss: HeightMapState, qpos: torch.Tensor) -> HeightMapState:
        origins = self.grid_points(qpos)
        flat = origins.reshape(qpos.shape[0], -1, 3)
        t = raycast_down(self.model, flat)
        down = self.model.const('ray_down', lambda: np.array([0.0, 0.0, -1.0]))
        hits = flat + t[..., None] * down
        # a missed cell keeps its last hit (heightmap.py:165-167)
        hits = torch.where((t < 0)[..., None], ss.points.reshape(flat.shape), hits)
        return HeightMapState(points=hits.reshape(origins.shape))

    def step(self, ss: HeightMapState, qpos, qvel, fwd, generator=None) -> HeightMapState:
        return self.update(ss, qpos)

    def get_observation(self, name, ss: HeightMapState):
        B = ss.points.shape[0]
        if name == 'height_map':
            return ss.points.reshape(B, -1)
        return ss.points[..., 2].reshape(B, -1)

    def get_height(self, ss: HeightMapState, target: torch.Tensor) -> torch.Tensor:
        """(B,) the height of the cell nearest each env's target (B, 3) in
        x and y, plus 0.02 (heightmap.py:209-220)."""
        pts = ss.points.reshape(ss.points.shape[0], -1, 3)
        d2 = ((pts[..., :2] - target[:, None, :2]) ** 2).sum(-1)
        return pts[..., 2].gather(1, d2.argmin(1, keepdim=True))[:, 0] + 0.02
