"""The port's host render paths against the JAX package's, on the CPU, in f64:
`Camera.image` and `Camera.save(rgb=True)`, `QuadrupedGymEnv.render` and
`close`, and `utils/replay.py`'s `replay_interactive` and `render_video`.

The robot is the joint tree of scripts/torch_port/make_joint_tree.py as
go2's robot file (the `assets` fixture of tests/test_torch_builder.py),
with a camera on its trunk; each package builds the tree's `Model` with its
own builder, and each builds its own display model from the same files.
The test hosts have no GL context, so the renderer and the viewer are
stand-ins, patched into `mujoco` for both packages:

* `Renderer`: `update_scene(d, camera=)` is `mujoco.mjv_updateScene` into a
  `MjvScene`, and `render()` an (H, W, 3) uint8 image expanded from a
  digest of the scene's geoms (type, size, pos, mat, rgba) and its camera,
  so two images are equal only where the scenes are, bit for bit. Both
  packages' images and `rgb.png` files are equal byte for byte.
* `launch_passive`: a handle with a `user_scn`, `sync`, `close` and
  `is_running`. `render` (with and without `tint_robot`, two ghost rows, a
  second call that reuses the arrows' ids) leaves every `user_scn` geom
  field, the viewer's qpos and qvel and the display model's colours equal
  to the reference's; `close` closes the viewer once.

With the real `mujoco.Renderer` where no GL context can be made, both
packages raise RuntimeError naming MUJOCO_GL; where one can, both render
the same pixels.
"""

import hashlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env import gym_adapter as jgym
from gym_quadruped_tpu.models import builder as jbuilder
from gym_quadruped_tpu.sensors import Camera as JCamera
from gym_quadruped_tpu.utils import replay as jreplay
from gym_quadruped_tpu_torch.env.gym_adapter import QuadrupedGymEnv
from gym_quadruped_tpu_torch.models import builder as pbuilder
from gym_quadruped_tpu_torch.models.model import to_device
from gym_quadruped_tpu_torch.sensors import Camera
from gym_quadruped_tpu_torch.utils import replay as preplay
from test_torch_builder import assets  # noqa: F401 (the fixture)

jax.config.update('jax_enable_x64', True)

MJV_FIELDS = ('type', 'size', 'pos', 'mat', 'rgba')
# looking forward and down from the trunk's front
CAMERA = '<camera name="trunkcam" pos="0.25 0 0.05" xyaxes="0 -1 0 0.3 0 1"/>\n      '
CAM_KW = dict(width=24, height=16, cam_name='trunkcam')
ROOT = Path(__file__).resolve().parents[1]


class Renderer:
    """`mujoco.Renderer` without GL: the scene of `mjv_updateScene`, the
    pixels a digest of it."""

    made = 0

    def __init__(self, model, height=240, width=320):
        import mujoco

        self._model, self._shape = model, (height, width, 3)
        self.scene = mujoco.MjvScene(model, maxgeom=500)
        self._camera, self._option = mujoco.MjvCamera(), mujoco.MjvOption()
        Renderer.made += 1

    def update_scene(self, data, camera=-1):
        import mujoco

        if isinstance(camera, str):
            camera = mujoco.mj_name2id(self._model, mujoco.mjtObj.mjOBJ_CAMERA, camera)
        if camera == -1:
            mujoco.mjv_defaultFreeCamera(self._model, self._camera)
        else:
            self._camera.type = mujoco.mjtCamera.mjCAMERA_FIXED
            self._camera.fixedcamid = camera
        mujoco.mjv_updateScene(self._model, data, self._option, None, self._camera,
                               mujoco.mjtCatBit.mjCAT_ALL, self.scene)

    def render(self):
        scn = self.scene
        parts = [np.array(getattr(scn.geoms[i], f)) for i in range(scn.ngeom) for f in MJV_FIELDS]
        parts += [np.array(getattr(scn.camera[0], f)) for f in ('pos', 'forward', 'up')]
        digest = b''.join(np.ascontiguousarray(p).tobytes() for p in parts)
        n = int(np.prod(self._shape))
        out = b''.join(hashlib.sha256(digest + k.to_bytes(4, 'little')).digest()
                       for k in range(-(-n // 32)))
        return np.frombuffer(out[:n], np.uint8).reshape(self._shape).copy()

    def close(self):
        pass


class Handle:
    """What the adapter and the replay use of a passive viewer."""

    def __init__(self, mujoco, mj, d, key_callback):
        self.model, self.data, self.key_callback = mj, d, key_callback
        self.user_scn = mujoco.MjvScene(mj, maxgeom=200)
        self.syncs, self.closed, self.poses = 0, 0, []

    def sync(self):
        self.syncs += 1
        self.poses.append(self.data.qpos.copy())

    def close(self):
        self.closed += 1

    def is_running(self):
        return not self.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture
def tree(assets):  # noqa: F811 (the fixture)
    """(mujoco, the port's DeviceModel of the tree with its trunk camera on
    the CPU in f64, the reference's Model, the assets directory)."""
    import mujoco

    path = next(assets.rglob('*.xml'))
    path.write_text(path.read_text().replace('<site name="imu"', CAMERA + '<site name="imu"'))
    pm, jm = pbuilder.build_model('go2', 'flat'), jbuilder.build_model('go2', 'flat')
    assert pm.cam_names == jm.cam_names == ('trunkcam',)
    return mujoco, to_device(pm, 'cpu', torch.float64), jm, assets


@pytest.fixture
def stand_ins(monkeypatch):
    """The stand-in renderer and viewer in `mujoco` (for both packages);
    yields the viewer handles opened."""
    import mujoco
    import mujoco.viewer

    handles = []

    def launch_passive(mj, d, key_callback=None):
        handles.append(Handle(mujoco, mj, d, key_callback))
        return handles[-1]

    monkeypatch.setattr(mujoco, 'Renderer', Renderer)
    monkeypatch.setattr(mujoco.viewer, 'launch_passive', launch_passive)
    return handles


def _qpos(m, seed):
    """The keyframe with its base moved and its joints offset, seeded."""
    rng = np.random.RandomState(seed)
    q = m.key_qpos[0].copy()
    q[:3] += rng.uniform(-0.1, 0.1, 3)
    q[7:] += rng.uniform(-0.2, 0.2, m.nq - 7)
    return q


def _scene(scn):
    return scn.ngeom, [{f: np.array(getattr(scn.geoms[i], f)) for f in MJV_FIELDS}
                       for i in range(scn.ngeom)]


def _same_scene(a, b):
    (na, ga), (nb, gb) = _scene(a), _scene(b)
    assert na == nb and na > 0
    for i, (x, y) in enumerate(zip(ga, gb)):
        for f in MJV_FIELDS:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f'geom {i} {f}')


def test_image_and_save_match(tree, stand_ins, tmp_path):
    _, dm, jm, _ = tree
    port, ref = Camera(dm, **CAM_KW), JCamera(jm, **CAM_KW)
    made = Renderer.made
    q1, q2 = _qpos(dm.m, 0), _qpos(dm.m, 1)
    for q in (q1, q2):
        got, want = port.image(torch.as_tensor(q)), ref.image(q)
        assert got.dtype == np.uint8 and got.shape == (16, 24, 3)
        np.testing.assert_array_equal(got, want)
    # one renderer per camera, built at its first image; the image follows qpos
    assert Renderer.made - made == 2
    assert not np.array_equal(port.image(q1), port.image(q2))
    np.testing.assert_array_equal(port.image(q1[None]), ref.image(q1))

    # the reference's depth files from the port's ray cast (held against the
    # reference's in test_torch_gym_utils.py): its eager cast takes seconds
    ref.shoot = lambda q: tuple(x[0].numpy() for x in port.shoot(torch.as_tensor(q)[None]))
    out = {name: cam.save(tmp_path / name, q2, rgb=True)
           for name, cam in (('port', port), ('ref', ref))}
    names = sorted(p.name for p in out['ref'].iterdir())
    assert names == sorted(p.name for p in out['port'].iterdir()) == [
        'depth.npy', 'depth.png', 'points.npy', 'rgb.png', 'seg.npy']
    for name in names:
        assert (out['port'] / name).read_bytes() == (out['ref'] / name).read_bytes(), name


def _adapters(dm, jm):
    """(the port's adapter, the reference's) on the tree, go2/flat."""
    kw = dict(robot='go2', scene='flat', state_obs_names=('qvel', 'base_lin_vel'))
    return QuadrupedGymEnv(model=dm, **kw), jgym.QuadrupedGymEnv(model=jm, **kw)


def _set_state(env, jenv, qpos, qvel, ref_lin):
    """The same state in both adapters: what `render` reads of it."""
    jenv._state = types.SimpleNamespace(qpos=qpos, qvel=qvel, ref_base_lin_vel_H=ref_lin)
    env._state = types.SimpleNamespace(
        **{k: torch.as_tensor(v)[None] for k, v in vars(jenv._state).items()})


@pytest.mark.parametrize('tint_robot', [False, True])
def test_render_matches(tree, stand_ins, tint_robot):
    _, dm, jm, _ = tree
    env, jenv = _adapters(dm, jm)
    rng = np.random.RandomState(2)
    ghosts = np.stack([_qpos(dm.m, 3), _qpos(dm.m, 4)])
    for call in range(2):
        qpos, qvel = _qpos(dm.m, 5 + call), rng.uniform(-0.5, 0.5, dm.m.nv)
        _set_state(env, jenv, qpos, qvel, np.array([0.4 - 0.3 * call, 0.1, 0.0]))
        env.render(tint_robot=tint_robot, ghost_qpos=torch.as_tensor(ghosts), ghost_alpha=0.3)
        jenv.render(tint_robot=tint_robot, ghost_qpos=ghosts, ghost_alpha=0.3)
        handle, jhandle = stand_ins
        assert handle.key_callback == env._key_callback
        assert handle.syncs == jhandle.syncs == call + 1
        np.testing.assert_array_equal(handle.data.qpos, qpos)
        np.testing.assert_array_equal(handle.data.qvel, qvel)
        np.testing.assert_array_equal(handle.model.geom_rgba, jhandle.model.geom_rgba)
        _same_scene(handle.user_scn, jhandle.user_scn)
        # the arrows first, then one user geom per robot geom: the ghost rows
        # redraw into the same ids, and a second call reuses all of them
        assert env._vis['arrow_ids'] == jenv._vis['arrow_ids'] == [0, 1]
        assert env._vis['ghost_geoms'] == jenv._vis['ghost_geoms']
        assert handle.user_scn.ngeom == 2 + len(env._vis['ghost_geoms'])
    assert len(stand_ins) == 2 and not handle.closed
    tinted = not np.array_equal(handle.model.geom_rgba,
                                pbuilder.build_display_mj_model('go2', 'flat')[0].geom_rgba)
    assert tinted == tint_robot


def test_close(tree, stand_ins):
    _, dm, jm, _ = tree
    env, jenv = _adapters(dm, jm)
    for e in (env, jenv):
        e.close()                   # before any render: nothing to close
        assert not hasattr(e, '_vis')
    _set_state(env, jenv, dm.m.key_qpos[0], np.zeros(dm.m.nv), np.zeros(3))
    for e in (env, jenv):
        e.render()
        e.close()
        e.close()
        assert not hasattr(e, '_vis')
    assert [h.closed for h in stand_ins] == [1, 1]
    env.render()                    # a render after close opens a new viewer
    assert len(stand_ins) == 3 and stand_ins[-1].syncs == 1


def test_replay_interactive_and_render_video(tree, stand_ins, tmp_path, monkeypatch):
    _, dm, _, _ = tree
    rng = np.random.RandomState(6)
    traj = np.stack([_qpos(dm.m, 10 + t) for t in range(5)])
    qvel = rng.randn(5, dm.m.nv)
    for mod in (preplay, jreplay):
        mod.replay_interactive(traj, 'go2', 'flat', dt=0.0, loop=False, qvel_traj=qvel)
    port, ref = stand_ins
    assert port.syncs == ref.syncs == 5 and port.closed == ref.closed == 1
    np.testing.assert_array_equal(np.stack(port.poses), traj)
    np.testing.assert_array_equal(np.stack(ref.poses), traj)
    np.testing.assert_array_equal(port.data.qvel, qvel[-1])

    kw = dict(fps=250, width=12, height=8, out_path=str(tmp_path / 'replay.mp4'))
    monkeypatch.setitem(sys.modules, 'imageio', None)     # no video writer: the frames
    frames = [mod.render_video(traj, 'go2', 'flat', **kw) for mod in (preplay, jreplay)]
    assert len(frames[0]) == len(frames[1]) == 3          # every 2nd of 5 at 250 fps
    for got, want in zip(*frames):
        assert got.shape == (8, 12, 3)
        np.testing.assert_array_equal(got, want)
    written = []
    monkeypatch.setitem(sys.modules, 'imageio', types.SimpleNamespace(
        mimsave=lambda path, fr, fps: written.append((path, np.stack(fr), fps))))
    assert [mod.render_video(traj, 'go2', 'flat', **kw) for mod in (preplay, jreplay)] == \
        [kw['out_path']] * 2
    (p1, f1, r1), (p2, f2, r2) = written
    assert p1 == p2 == kw['out_path'] and r1 == r2 == 250
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(f1, np.stack(frames[0]))


# One package's real render in a fresh interpreter: where no GL context can
# be made, MuJoCo aborts the process at its second failed Renderer, so each
# attempt runs alone. argv: the package, 'image' or 'save', qpos.npy, the
# output (image.npy, or the directory `save` writes under).
REAL = r'''
import json, sys
import numpy as np
package, action, qpos, out = sys.argv[1:]
kw = dict(width=24, height=16, cam_name='trunkcam')
if package == 'port':
    import torch
    from gym_quadruped_tpu_torch.models import builder
    from gym_quadruped_tpu_torch.models.model import to_device
    from gym_quadruped_tpu_torch.sensors import Camera
    cam = Camera(to_device(builder.build_model('go2', 'flat'), 'cpu', torch.float64), **kw)
else:
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from gym_quadruped_tpu.models import builder
    from gym_quadruped_tpu.sensors import Camera
    cam = Camera(builder.build_model('go2', 'flat'), **kw)
q = np.load(qpos)
try:
    if action == 'image':
        np.save(out, cam.image(q))
        result = {'ok': True, 'path': out}
    else:
        result = {'ok': True, 'path': str(cam.save(out, q, rgb=True) / 'rgb.png')}
except Exception as e:
    result = {'ok': False, 'type': type(e).__name__, 'message': str(e)}
print(json.dumps(result))
'''
_REAL_RUNS = {}
# the reference's `save(rgb=True)` renders through its `image`
RUNS = (('port', 'image'), ('ref', 'image'), ('port', 'save'))


def _real_runs(tree, tmp_path):
    """{(package, action): the outcome} of the real renders of RUNS, each
    in its own interpreter, all at once; run once per test process."""
    if not _REAL_RUNS:
        _, dm, _, assets = tree
        env = {**os.environ, 'GYM_QUADRUPED_ASSETS': str(assets), 'TMPDIR': str(tmp_path),
               'PYTHONPATH': os.pathsep.join([str(ROOT)] + [p for p in [
                   os.environ.get('PYTHONPATH')] if p])}
        qpos = tmp_path / 'qpos.npy'
        np.save(qpos, _qpos(dm.m, 0))
        for package, action in RUNS:
            (tmp_path / f'{package}-{action}').mkdir()
        procs = {(package, action): subprocess.Popen(
            [sys.executable, '-c', REAL, package, action, str(qpos),
             str(tmp_path / f'{package}-{action}' / ('image.npy' if action == 'image' else ''))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for package, action in RUNS}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, f'{key}: {err[-2000:]}'
            _REAL_RUNS[key] = json.loads(out.strip().splitlines()[-1])
    return _REAL_RUNS


def test_real_renderer_without_gl(tree, tmp_path):
    runs = _real_runs(tree, tmp_path)
    if all(r['ok'] for r in runs.values()):
        pytest.skip('a GL context can be made here: test_real_pixels_match compares')
    for key, r in runs.items():
        assert not r['ok'] and r['type'] == 'RuntimeError', (key, r)
        assert 'MUJOCO_GL' in r['message'] and 'Underlying error' in r['message'], (key, r)
    assert runs['port', 'image']['message'] == runs['ref', 'image']['message']


def test_real_pixels_match(tree, tmp_path):
    runs = _real_runs(tree, tmp_path)
    if not all(r['ok'] for r in runs.values()):
        why = next(r['message'] for r in runs.values() if not r['ok'])
        pytest.skip(f'no GL context can be made here ({why[:160]})')
    got, want = (np.load(runs[p, 'image']['path']) for p in ('port', 'ref'))
    assert got.shape == (16, 24, 3) and got.dtype == np.uint8 and got.any()
    np.testing.assert_array_equal(got, want)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(runs['port', 'save']['path'])), got)
