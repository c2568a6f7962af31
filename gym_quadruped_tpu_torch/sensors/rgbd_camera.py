"""Depth, segmentation and point-cloud camera by analytic ray casting,
batched over envs.

Counterpart of gym_quadruped_tpu/sensors/rgbd_camera.py (the reference's
Camera, rgbd_camera.py:12-334, with the intended semantics of its frame
and constructor):

  * intrinsic_mat: the pinhole K from fovy (rgbd_camera.py:117-145);
  * render: one ray per pixel against the world and the robot's primitives
    (`physics.raycast.raycast`), Euclidean and plane depth, the nearest
    geom's id per pixel (-1 on a miss) and the point cloud in camera
    coordinates;
  * step: with auto_render, re-render an env when its sim time has advanced
    1/fps past its last render (rgbd_camera.py:32-33). Every env is
    rendered and the gate picks per env, as the reference's vmapped
    `lax.cond` does: envs reset apart keep their own clocks.

RGB (`image`, `save(rgb=True)`) is a host render, as in the reference: a
CPU `mujoco.Renderer` of the display model that
`models.builder.build_display_mj_model` compiles from the robot's MJCF,
posed at one env's qpos. It needs `mujoco` and a GL backend (EGL or
OSMesa); `save` writes the depth, seg and point cloud files without them.

MuJoCo's camera convention: it looks along -z, +y up in the image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel
from gym_quadruped_tpu_torch.physics.kinematics import Kin, fk
from gym_quadruped_tpu_torch.physics.raycast import raycast, static_mat
from gym_quadruped_tpu_torch.sensors.base import Sensor
from gym_quadruped_tpu_torch.utils.maths import quat_to_mat


@dataclasses.dataclass
class CameraState:
    depth: torch.Tensor      # (B, H, W) Euclidean depth of the last render
    seg: torch.Tensor        # (B, H, W) int32 geom ids
    last_time: torch.Tensor  # (B,) sim time of the last render
    time: torch.Tensor       # (B,) sim time, advanced every step


class Camera(Sensor):
    """See the module docstring. The constructor mirrors the reference's
    (rgbd_camera.py:15-55)."""

    def __init__(self, model: DeviceModel, width: int = 64, height: int = 64,
                 fps: float = 30.0, cam_name: str = '', auto_render: bool = False):
        self.model = model
        m = model.m
        self._width = width
        self._height = height
        self.interval = float(1.0 / fps)
        self.auto_render = auto_render
        self._cam_id = m.name2id('camera', cam_name) if cam_name else 0
        if m.cam_fovy.shape[0] == 0:
            raise ValueError(f'model {m.robot} has no cameras')
        self._body_id = int(m.cam_bodyid[self._cam_id])

    # ------------------------------------------------------------- geometry

    @property
    def width(self):
        return self._width

    @property
    def height(self):
        return self._height

    @property
    def fov(self) -> float:
        return float(self.model.m.cam_fovy[self._cam_id])

    @property
    def id(self) -> int:
        return self._cam_id

    @property
    def intrinsic_mat(self) -> np.ndarray:
        theta = np.deg2rad(self.fov)
        f_x = (self._width / 2) / np.tan(theta / 2)
        f_y = (self._height / 2) / np.tan(theta / 2)
        u_0 = (self._width - 1) / 2.0
        v_0 = (self._height - 1) / 2.0
        return np.array([[f_x, 0, u_0], [0, f_y, v_0], [0, 0, 1]])

    def frame_config(self, kin: Kin):
        """The camera's pose (R (B, 3, 3), p (B, 3)) in world coordinates
        (the intended semantics of rgbd_camera.py:146-161)."""
        dm, c = self.model, self._cam_id
        Rb = quat_to_mat(kin.xquat[:, self._body_id])
        p = kin.xpos[:, self._body_id] + (Rb * dm.const(('cam_pos', c),
                                                         lambda: dm.m.cam_pos[c])).sum(-1)
        R = Rb @ dm.const(('cam_mat', c), lambda: static_mat(dm.m.cam_quat[c]))
        return R, p

    def _pixel_dirs(self) -> np.ndarray:
        """(H*W, 3) unit ray directions in the camera frame (-z forward, +y up)."""
        K = self.intrinsic_mat
        v, u = np.meshgrid(np.arange(self._height), np.arange(self._width), indexing='ij')
        x = (u - K[0, 2]) / K[0, 0]
        y = -(v - K[1, 2]) / K[1, 1]
        d = np.stack([x, y, -np.ones_like(x)], axis=-1).reshape(-1, 3)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    # -------------------------------------------------------------- render

    def render(self, kin: Kin):
        """(depth_euclid (B, H, W), depth_plane (B, H, W), seg (B, H, W)
        int32, point_cloud (B, H*W, 3) in camera coordinates) of the states
        that `kin` poses."""
        B, H, W = kin.xpos.shape[0], self._height, self._width
        R, p = self.frame_config(kin)
        dirs_cam = self.model.const(('cam_dirs', self._cam_id, H, W), self._pixel_dirs)
        dirs = dirs_cam @ R.transpose(1, 2)                 # (B, H*W, 3) world directions
        t, gid = raycast(self.model, p[:, None, :].expand_as(dirs), dirs, kin=kin)
        miss = t < 0
        t = torch.where(miss, 0.0, t)
        depth_e = t.reshape(B, H, W)
        depth_p = (t * -dirs_cam[:, 2]).reshape(B, H, W)   # along the camera's -z axis
        seg = torch.where(miss, -1, gid).reshape(B, H, W)
        return depth_e, depth_p, seg, dirs_cam * t[..., None]

    def depth_image(self, kin: Kin):
        return self.render(kin)[0]

    def seg_image(self, kin: Kin):
        return self.render(kin)[2]

    def point_cloud(self, kin: Kin):
        return self.render(kin)[3]

    def shoot(self, qpos: torch.Tensor):
        """FK and render from qpos (B, nq)."""
        return self.render(fk(self.model, qpos))

    def image(self, qpos) -> np.ndarray:
        """The (H, W, 3) uint8 RGB image of one env at qpos (nq,), a tensor on
        any device or an array (reference rgbd_camera.py:176): a host render
        of the display model, built with its renderer at the first call.
        Needs a GL backend: raises RuntimeError with guidance where none
        can be had."""
        import mujoco

        from gym_quadruped_tpu_torch.models.builder import build_display_mj_model

        if not hasattr(self, '_vis'):
            m = self.model.m
            mj, _ = build_display_mj_model(m.robot, m.scene, float(m.timestep))
            try:
                renderer = mujoco.Renderer(mj, height=self._height, width=self._width)
            except Exception as e:  # a host without EGL or OSMesa
                raise RuntimeError(
                    'RGB rendering needs an OpenGL backend; set MUJOCO_GL=egl '
                    'or MUJOCO_GL=osmesa (depth/seg/point_cloud do not — they '
                    f'ray-cast on device). Underlying error: {e}') from e
            self._vis = (mj, mujoco.MjData(mj), renderer)
        mj, d, renderer = self._vis
        d.qpos[:] = torch.as_tensor(qpos).detach().cpu().numpy().reshape(-1)   # one host copy
        mujoco.mj_forward(mj, d)
        renderer.update_scene(d, camera=self.model.m.cam_names[self._cam_id])
        return renderer.render()

    def save(self, out_dir, qpos, rgb: bool = False):
        """Write the depth (.npy and .png), seg (.npy) and point cloud (.npy)
        of one env at qpos (nq,), and with `rgb` its RGB image (.png), into a
        timestamped directory under `out_dir` (reference
        rgbd_camera.py:173-191), and return it. The depth image is scaled
        to [0, 255], near bright."""
        import time as _time
        from pathlib import Path

        from PIL import Image

        q = torch.as_tensor(qpos, dtype=self.model.dtype, device=self.model.device)
        depth_e, _, seg, pc = (x[0].cpu().numpy() for x in self.shoot(q.reshape(1, -1)))
        out = Path(out_dir) / _time.strftime('%Y%m%d_%H%M%S')
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / 'depth.npy', depth_e)
        np.save(out / 'seg.npy', seg)
        np.save(out / 'points.npy', pc)
        lo, hi = float(depth_e.min()), float(depth_e.max())
        norm = (depth_e - lo) / (hi - lo) if hi > lo else depth_e * 0
        Image.fromarray((255 * (1 - norm)).astype(np.uint8)).save(out / 'depth.png')
        if rgb:
            Image.fromarray(self.image(qpos)).save(out / 'rgb.png')
        return out

    # ------------------------------------------------------ sensor protocol

    def available_observations(self):
        return ('depth_image', 'seg_image')

    def observation_dim(self, name):
        return self._height * self._width

    def init(self, generator, B):
        dm = self.model
        z = torch.zeros(B, self._height, self._width, dtype=dm.dtype, device=dm.device)
        return CameraState(depth=z, seg=torch.zeros_like(z, dtype=torch.int32),
                           last_time=torch.full((B,), -1e9, dtype=dm.dtype, device=dm.device),
                           time=torch.zeros(B, dtype=dm.dtype, device=dm.device))

    def step(self, ss: CameraState, qpos, qvel, fwd, generator=None) -> CameraState:
        """With auto_render, the fps-gated render of each env (rgbd_camera.py:32-33):
        an env re-renders when its time has advanced 1/fps past its last
        render."""
        if not self.auto_render:
            return ss
        t = ss.time + self.model.timestep
        due = (t - ss.last_time) >= self.interval - 1e-9
        depth, _, seg, _ = self.render(fwd.kin)
        pick = due[:, None, None]
        return CameraState(depth=torch.where(pick, depth, ss.depth),
                           seg=torch.where(pick, seg, ss.seg),
                           last_time=torch.where(due, t, ss.last_time), time=t)

    def get_observation(self, name, ss: CameraState):
        B = ss.depth.shape[0]
        if name == 'depth_image':
            return ss.depth.reshape(B, -1)
        return ss.seg.reshape(B, -1).to(ss.depth.dtype)
