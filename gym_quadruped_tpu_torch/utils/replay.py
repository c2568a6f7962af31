"""Trajectory replay and visualization through CPU MuJoCo.

The port's copy of gym_quadruped_tpu/utils/replay.py. The batched simulation
on the card has no live viewer: its (qpos, qvel) trajectories go to the H5
store (`utils.data.H5Writer`) and are replayed here on the host, in the
display model of `models.builder.build_display_mj_model` (the reference's
offline pattern, examples/dataset_reproduction.py:61-141).

Needs the `mujoco` package, imported when called; the viewer and the
offscreen video need a GL context (EGL or OSMesa).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def _build(robot: str, scene: str):
    import mujoco

    from gym_quadruped_tpu_torch.models.builder import build_display_mj_model

    mj, _ = build_display_mj_model(robot, scene)
    return mujoco, mj


def replay_interactive(qpos_traj, robot: str, scene: str = 'flat',
                       dt: float = 0.002, loop: bool = True,
                       qvel_traj=None):
    """Replay a (T, nq) qpos trajectory in the interactive MuJoCo viewer."""
    mujoco, mj = _build(robot, scene)
    import mujoco.viewer

    d = mujoco.MjData(mj)
    qpos_traj = np.asarray(qpos_traj)
    with mujoco.viewer.launch_passive(mj, d) as viewer:
        while viewer.is_running():
            for t in range(qpos_traj.shape[0]):
                d.qpos[:] = qpos_traj[t]
                if qvel_traj is not None:
                    d.qvel[:] = np.asarray(qvel_traj)[t]
                mujoco.mj_forward(mj, d)
                viewer.sync()
                time.sleep(dt)
                if not viewer.is_running():
                    break
            if not loop:
                break


def render_video(qpos_traj, robot: str, scene: str = 'flat',
                 out_path: str | Path = 'replay.mp4', fps: int = 50,
                 width: int = 640, height: int = 480, camera=-1,
                 sim_dt: float = 0.002):
    """Render a (T, nq) qpos trajectory to an mp4/frame stack offscreen.

    Returns the list of frames if no video writer is available.
    """
    mujoco, mj = _build(robot, scene)
    d = mujoco.MjData(mj)
    qpos_traj = np.asarray(qpos_traj)
    stride = max(1, int(round(1.0 / (fps * sim_dt))))
    renderer = mujoco.Renderer(mj, height, width)
    frames = []
    for t in range(0, qpos_traj.shape[0], stride):
        d.qpos[:] = qpos_traj[t]
        mujoco.mj_forward(mj, d)
        renderer.update_scene(d, camera=camera)
        frames.append(renderer.render())
    renderer.close()
    try:
        import imageio

        imageio.mimsave(str(out_path), frames, fps=fps)
        return str(out_path)
    except ImportError:
        return frames


def replay_h5(h5_path, episode: int = 0, interactive: bool = True, **kw):
    """Replay an episode from an H5 recording (env reconstruction from the stored
    hyperparameters — the reference round-trip property, h5py.py:106)."""
    from gym_quadruped_tpu_torch.utils.data.h5 import H5Reader

    reader = H5Reader(h5_path)
    hp = reader.env_hparams
    _, traj = reader.get_trajectory(episode)
    robot = hp.get('robot', 'go2')
    scene = hp.get('scene', 'flat')
    qpos = traj['qpos']
    fn = replay_interactive if interactive else render_video
    return fn(qpos, robot=robot, scene=scene, **kw)
