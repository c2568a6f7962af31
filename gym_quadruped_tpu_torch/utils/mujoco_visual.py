"""Viewer decoration helpers for replaying trajectories through CPU MuJoCo.

The port's copy of gym_quadruped_tpu/utils/mujoco_visual.py (the reference's
utils/mujoco/visual.py:14-343): arrows, spheres, lines and frames drawn into
a viewer's `user_scn` (a `mujoco.MjvScene`) with geom-id reuse, per-leg robot
tinting, and transparent "ghost robot" copies. Host tooling beside
`utils.replay`: the batched simulation on the card never draws.

Every function imports `mujoco` when called (a host tool's dependency; the
GPU host need not have it).
"""

from __future__ import annotations

import numpy as np


def _ortho_frame(vector: np.ndarray) -> np.ndarray:
    """Rotation matrix whose z-axis is `vector` (Gram-Schmidt, like the
    reference's arrow orientation, visual.py:49-57)."""
    z = vector / (np.linalg.norm(vector) + 1e-12)
    helper = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = helper - z * (helper @ z)
    x /= np.linalg.norm(x) + 1e-12
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def _next_geom(viewer, geom_id: int):
    import mujoco

    if geom_id < 0:
        if viewer.user_scn.ngeom >= len(viewer.user_scn.geoms):
            raise RuntimeError('user_scn geom buffer exhausted')
        viewer.user_scn.ngeom += 1
        geom_id = viewer.user_scn.ngeom - 1
    return mujoco, viewer.user_scn.geoms[geom_id], geom_id


def render_vector(viewer, vector, pos, scale, color=None, geom_id: int = -1,
                  diameter: float = 0.015) -> int:
    """Arrow at `pos` along `vector` with length `scale` (visual.py:14-70)."""
    color = np.asarray(color if color is not None else [1, 0, 0, 1], np.float32)
    mujoco, geom, geom_id = _next_geom(viewer, geom_id)
    mujoco.mjv_initGeom(
        geom, type=mujoco.mjtGeom.mjGEOM_ARROW,
        size=np.asarray([diameter, diameter, scale], np.float64),
        pos=np.asarray(pos, np.float64),
        mat=_ortho_frame(np.asarray(vector, np.float64)).flatten(),
        rgba=color)
    return geom_id


def render_sphere(viewer, position, diameter, color=None,
                  geom_id: int = -1) -> int:
    """Sphere marker (visual.py:73-113)."""
    color = np.asarray(color if color is not None else [1, 0, 0, 1], np.float32)
    mujoco, geom, geom_id = _next_geom(viewer, geom_id)
    mujoco.mjv_initGeom(
        geom, type=mujoco.mjtGeom.mjGEOM_SPHERE,
        size=np.ones(3) * diameter / 2,
        pos=np.asarray(position, np.float64),
        mat=np.eye(3).flatten(), rgba=color)
    return geom_id


def render_line(viewer, initial_point, target_point, width, color=None,
                geom_id: int = -1) -> int:
    """Capsule segment between two points (visual.py:115-170)."""
    color = np.asarray(color if color is not None else [1, 0, 0, 1], np.float32)
    mujoco, geom, geom_id = _next_geom(viewer, geom_id)
    a = np.asarray(initial_point, np.float64)
    b = np.asarray(target_point, np.float64)
    seg = b - a
    length = np.linalg.norm(seg)
    mujoco.mjv_initGeom(
        geom, type=mujoco.mjtGeom.mjGEOM_CAPSULE,
        size=np.asarray([width, length / 2, 0.0]),
        pos=(a + b) / 2,
        mat=_ortho_frame(seg / (length + 1e-12)).flatten(), rgba=color)
    return geom_id


def render_frame(viewer, R, pos, scale: float = 0.2, geom_ids=None) -> list:
    """Draw an SE(3) frame as three colored axis arrows (visual.py:172-226)."""
    geom_ids = geom_ids if geom_ids is not None else [-1, -1, -1]
    colors = [(1, 0, 0, 1), (0, 1, 0, 1), (0, 0, 1, 1)]
    R = np.asarray(R)
    return [render_vector(viewer, R[:, i], pos, scale, colors[i], geom_ids[i])
            for i in range(3)]


def change_robot_appearance(mj_model, alpha: float = 1.0):
    """Per-leg tinting (FL/FR/RL/RR hues) + base color (visual.py:229-261)."""
    # robot-agnostic: tint by leg-name prefix in the geom's body name
    palette = {'FL': (0.698, 0.376, 0.082), 'FR': (0.502, 0.251, 0.0),
               'RL': (0.296, 0.719, 0.314), 'RR': (0.176, 0.439, 0.196)}
    import mujoco

    for gid in range(mj_model.ngeom):
        bid = mj_model.geom_bodyid[gid]
        bname = mujoco.mj_id2name(mj_model, mujoco.mjtObj.mjOBJ_BODY, bid) or ''
        for leg, rgb in palette.items():
            if bname.startswith(leg):
                mj_model.geom_rgba[gid] = (*rgb, alpha)
                break
        else:
            if bid != 0:
                mj_model.geom_rgba[gid] = (0.35, 0.35, 0.38, alpha)


def render_ghost_robot(viewer, mj_model, mj_data, qpos, alpha: float = 0.5,
                       ghost_geoms: dict | None = None) -> dict:
    """Transparent decorative copy of the robot at `qpos` (visual.py:263-343):
    forwards a scratch MjData to the pose and mirrors each visible robot geom
    into user_scn with the given alpha. Returns {user_scn geom id: model geom id}
    for reuse on subsequent calls."""
    import mujoco

    mujoco.mj_forward(mj_model, mj_data)
    mj_data.qpos[:] = np.asarray(qpos)
    mujoco.mj_forward(mj_model, mj_data)

    ghost_geoms = dict(ghost_geoms or {})
    robot_geoms = [g for g in range(mj_model.ngeom)
                   if mj_model.geom_bodyid[g] != 0
                   and mj_model.geom_rgba[g][3] > 0]
    if not ghost_geoms:
        for g in robot_geoms:
            if viewer.user_scn.ngeom >= len(viewer.user_scn.geoms):
                break
            viewer.user_scn.ngeom += 1
            ghost_geoms[viewer.user_scn.ngeom - 1] = g

    for scn_id, g in ghost_geoms.items():
        dec = viewer.user_scn.geoms[scn_id]
        gtype = int(mj_model.geom_type[g])
        if gtype == mujoco.mjtGeom.mjGEOM_MESH:
            # meshes can't be re-instanced into user_scn portably; draw the
            # geom's bounding sphere instead
            mujoco.mjv_initGeom(dec, type=mujoco.mjtGeom.mjGEOM_SPHERE,
                                size=np.ones(3) * float(mj_model.geom_rbound[g]),
                                pos=mj_data.geom_xpos[g],
                                mat=mj_data.geom_xmat[g],
                                rgba=np.asarray([*mj_model.geom_rgba[g][:3],
                                                 alpha], np.float32))
        else:
            mujoco.mjv_initGeom(dec, type=gtype,
                                size=mj_model.geom_size[g],
                                pos=mj_data.geom_xpos[g],
                                mat=mj_data.geom_xmat[g],
                                rgba=np.asarray([*mj_model.geom_rgba[g][:3],
                                                 alpha], np.float32))
    return ghost_geoms
