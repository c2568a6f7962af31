"""The port's replay tools (`utils/mujoco_visual.py`, `utils/replay.py`)
against the JAX package's, on the CPU.

Each `render_*` helper draws into a stand-in viewer whose `user_scn` is a
`mujoco.MjvScene` (no GL context needed): the geoms the port's helper writes
equal the reference's, field by field, and geom ids are reused alike. The
robot is the joint tree of scripts/torch_port/make_joint_tree.py as go2's
robot file in a temporary robot_model directory ($GYM_QUADRUPED_ASSETS).
`replay_h5` reads an episode the port's H5Writer wrote and hands its qpos,
robot and scene to the renderer; `_build` compiles the port's display
model. The viewer window and the offscreen video need a GL context, which
the test hosts lack: they are not run.
"""

import numpy as np
import pytest

from gym_quadruped_tpu.models import builder as jbuilder
from gym_quadruped_tpu.utils import mujoco_visual as jvis
from gym_quadruped_tpu_torch.models import builder as pbuilder
from gym_quadruped_tpu_torch.utils import mujoco_visual as pvis
from gym_quadruped_tpu_torch.utils import replay as preplay
from test_torch_builder import assets  # noqa: F401 (the fixture)

MJV_FIELDS = ('type', 'size', 'pos', 'mat', 'rgba')


class Viewer:
    """What the helpers use of a passive viewer: its user scene."""

    def __init__(self, mujoco, mj, maxgeom=40):
        self.user_scn = mujoco.MjvScene(mj, maxgeom=maxgeom)


@pytest.fixture
def display(assets):  # noqa: F811 (the fixture)
    """(mujoco, the port's display mjModel of the tree on flat)."""
    import mujoco

    return mujoco, pbuilder.build_display_mj_model('go2', 'flat')[0]


def _scene(viewer):
    scn = viewer.user_scn
    return scn.ngeom, [{f: np.array(getattr(scn.geoms[i], f)) for f in MJV_FIELDS}
                       for i in range(scn.ngeom)]


def _same_scene(a, b):
    (na, ga), (nb, gb) = _scene(a), _scene(b)
    assert na == nb and na > 0
    for i, (x, y) in enumerate(zip(ga, gb)):
        for f in MJV_FIELDS:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f'geom {i} {f}')


def _draw(mod, viewer):
    """Every primitive helper twice: drawn anew, then redrawn into its ids."""
    ids = [mod.render_vector(viewer, [0.3, -0.2, 0.9], [0.1, 0.2, 0.3], 0.4),
           mod.render_sphere(viewer, [1.0, 0.0, 0.5], 0.05, color=[0, 1, 0, 0.5]),
           mod.render_line(viewer, [0, 0, 0], [0.2, 0.4, 0.1], 0.01, color=[0, 0, 1, 1]),
           *mod.render_frame(viewer, np.eye(3)[[1, 2, 0]], [0.5, 0.5, 0.5], scale=0.3)]
    again = [mod.render_vector(viewer, [0, 0, 1], [0, 0, 0], 0.2, geom_id=ids[0]),
             mod.render_sphere(viewer, [0, 1, 0], 0.1, geom_id=ids[1]),
             mod.render_line(viewer, [1, 1, 1], [1, 1, 2], 0.02, geom_id=ids[2]),
             *mod.render_frame(viewer, np.eye(3), [0, 0, 1], geom_ids=ids[3:])]
    return ids, again


def test_primitives_match(display):
    mujoco, mj = display
    port, ref = Viewer(mujoco, mj), Viewer(mujoco, mj)
    ids, again = _draw(pvis, port)
    assert (ids, again) == _draw(jvis, ref)
    assert ids == again == list(range(6))
    _same_scene(port, ref)


def test_buffer_exhausted(display):
    mujoco, mj = display
    for mod in (pvis, jvis):
        viewer = Viewer(mujoco, mj, maxgeom=1)
        mod.render_sphere(viewer, [0, 0, 0], 0.1)
        with pytest.raises(RuntimeError, match='exhausted'):
            mod.render_sphere(viewer, [0, 0, 0], 0.1)


def test_appearance_and_ghost_match(display):
    mujoco, mj = display
    mj_ref, _ = jbuilder.build_display_mj_model('go2', 'flat')
    pvis.change_robot_appearance(mj, alpha=0.7)
    jvis.change_robot_appearance(mj_ref, alpha=0.7)
    np.testing.assert_array_equal(mj.geom_rgba, mj_ref.geom_rgba)
    qpos = mj.key_qpos[0].copy()
    qpos[:3] += [0.2, -0.1, 0.05]
    port, ref = Viewer(mujoco, mj), Viewer(mujoco, mj_ref)
    ghosts = pvis.render_ghost_robot(port, mj, mujoco.MjData(mj), qpos, alpha=0.4)
    assert ghosts == jvis.render_ghost_robot(ref, mj_ref, mujoco.MjData(mj_ref), qpos, alpha=0.4)
    _same_scene(port, ref)
    # the second call redraws into the same user_scn geoms
    qpos[0] += 0.3
    again = pvis.render_ghost_robot(port, mj, mujoco.MjData(mj), qpos, ghost_geoms=ghosts)
    assert again == ghosts and port.user_scn.ngeom == len(ghosts)


def test_build_and_replay_h5(display, tmp_path, monkeypatch):
    pytest.importorskip('h5py')
    import torch

    from gym_quadruped_tpu_torch.utils.data import H5Writer

    mujoco, mj = display
    got_mujoco, built = preplay._build('go2', 'flat')
    assert got_mujoco is mujoco
    for f in ('nq', 'nv', 'nbody', 'ngeom'):
        assert getattr(built, f) == getattr(mj, f), f
    rng = np.random.RandomState(0)
    traj = {'qpos': rng.randn(2, 7, mj.nq), 'qvel': rng.randn(2, 7, mj.nv)}
    writer = H5Writer(tmp_path / 'rec.h5', obs_dims={'qpos': (mj.nq,), 'qvel': (mj.nv,)},
                      env_hparams={'robot': 'go2', 'scene': 'flat'})
    writer.append_batch({k: torch.as_tensor(v) for k, v in traj.items()},
                        torch.arange(7.0).expand(2, 7)[..., None])
    calls = []
    monkeypatch.setattr(preplay, 'render_video', lambda *a, **kw: calls.append((a, kw)) or 'ok')
    assert preplay.replay_h5(tmp_path / 'rec.h5', episode=1, interactive=False, fps=25) == 'ok'
    (args, kw), = calls
    np.testing.assert_array_equal(args[0], traj['qpos'][1])
    assert kw == {'robot': 'go2', 'scene': 'flat', 'fps': 25}
