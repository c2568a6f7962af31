"""The gym adapter's utilities against the JAX package's, in f64.

* The 7 maths helpers the adapter and the symmetry path need
  (`quat_identity`, `quat_conj`, `quat_rotate_inv`, `mat_to_quat`,
  `angle_between_vectors`, `homogenous_transform`, `process_range`) on
  seeded batches, to 1e-12; `mat_to_quat` also on matrices near each of
  Shepperd's four branches.
* `LegsAttr`'s operators, indexing and iteration against the reference's.
* `augment_obs_data` against the reference's on the duck-typed reflection
  group of tests/test_symmetry.py; the representations raise ImportError
  without morpho_symm, as the reference's do.
* `Camera.save` on aliengo/flat's robotcam: the same four files as the
  reference's, `.npy` to 1e-9, the png within one grey level;
  `save(rgb=True)` raises the reference's exception where aliengo's MJCF
  is not to be found (tests/test_torch_render.py renders RGB).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.utils import legs as jlegs
from gym_quadruped_tpu.utils import maths as jmaths
from gym_quadruped_tpu.utils import symmetry as jsym
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.utils import legs, maths, symmetry
from test_symmetry import _MirrorRep, _mk_group

TOL = 1e-12


def _quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, tol=TOL, where=''):
    assert isinstance(got, torch.Tensor), where
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=where)


def test_quat_identity_conj_rotate_inv():
    rng = np.random.RandomState(0)
    q = _quats(rng, 6).reshape(2, 3, 4)
    v = rng.randn(2, 3, 3)
    _close(maths.quat_identity(torch.float64), jmaths.quat_identity(np.float64))
    assert maths.quat_identity().dtype == torch.float32
    _close(maths.quat_conj(torch.as_tensor(q)), jmaths.quat_conj(q))
    _close(maths.quat_rotate_inv(torch.as_tensor(q), torch.as_tensor(v)),
           jmaths.quat_rotate_inv(q, v))
    # the inverse rotation undoes the rotation
    back = maths.quat_rotate(torch.as_tensor(q), maths.quat_rotate_inv(torch.as_tensor(q),
                                                                        torch.as_tensor(v)))
    _close(back, v)


def test_mat_to_quat():
    rng = np.random.RandomState(1)
    q = _quats(rng, 16)
    # near each branch: rotations by ~pi about x, y, z, and the identity
    for axis in range(3):
        near = np.zeros(4)
        near[1 + axis] = 1.0
        near[0] = 1e-3
        q = np.concatenate([q, (near / np.linalg.norm(near))[None]])
    q = np.concatenate([q, [[1.0, 0.0, 0.0, 0.0]]])
    R = np.array(jmaths.quat_to_mat(q))
    got = maths.mat_to_quat(torch.as_tensor(R))
    _close(got, jmaths.mat_to_quat(R))
    # the same rotation back, w >= 0
    _close(maths.quat_to_mat(got), R)
    assert bool((got[:, 0] >= 0).all())


def test_angle_and_homogenous_transform():
    rng = np.random.RandomState(2)
    v1, v2 = rng.randn(5, 3), rng.randn(5, 3)
    _close(maths.angle_between_vectors(torch.as_tensor(v1), torch.as_tensor(v2)),
           jmaths.angle_between_vectors(v1, v2))
    X = np.tile(np.eye(4), (5, 1, 1))
    X[:, :3, :3] = np.asarray(jmaths.quat_to_mat(_quats(rng, 5)))
    X[:, :3, 3] = rng.randn(5, 3)
    p = rng.randn(5, 3)
    _close(maths.homogenous_transform(torch.as_tensor(p), torch.as_tensor(X)),
           jmaths.homogenous_transform(p, X))


@pytest.mark.parametrize('value', [0.5, 2, np.float64(0.25), (0.0, 1.0), [-1, 3]])
def test_process_range(value):
    assert maths.process_range(value) == jmaths.process_range(value)
    assert all(isinstance(x, float) for x in maths.process_range(value))


def test_process_range_rejects():
    for bad in ((1.0, 2.0, 3.0), [1.0]):
        with pytest.raises(ValueError):
            maths.process_range(bad)
        with pytest.raises(ValueError):
            jmaths.process_range(bad)


def test_legs_attr():
    rng = np.random.RandomState(3)
    vals = [rng.randn(3, 3) for _ in range(4)]
    other = [rng.randn(3, 3) for _ in range(4)]
    a, b = legs.LegsAttr(*vals), legs.LegsAttr(*other)
    ja, jb = jlegs.LegsAttr(*vals), jlegs.LegsAttr(*other)
    for op in ('__add__', '__sub__', '__mul__', '__truediv__', '__matmul__'):
        for rhs, jrhs in ((b, jb), (2.5, 2.5)):
            if op == '__matmul__' and not isinstance(rhs, legs.LegsAttr):
                rhs = jrhs = np.eye(3)
            got, want = getattr(a, op)(rhs), getattr(ja, op)(jrhs)
            assert isinstance(got, legs.LegsAttr)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=op)
    assert legs.LEG_ORDER == jlegs.LEG_ORDER
    assert [id(x) for x in a] == [id(x) for x in vals]
    assert a.to_list(('RR', 'FL')) == [vals[3], vals[0]]
    a['RL'] = 7
    assert a.RL == 7 and a['RL'] == 7
    with pytest.raises(AssertionError):
        a['XX']
    with pytest.raises(AssertionError):
        a['XX'] = 1
    assert repr(legs.LegsAttr(1, 2, 3, 4)) == repr(jlegs.LegsAttr(1, 2, 3, 4))


def test_augment_obs_data():
    G, r3 = _mk_group()
    rng = np.random.RandomState(4)
    qpos = np.concatenate([rng.normal(size=(5, 3)), _quats(rng, 5), rng.normal(size=(5, 12))], -1)

    def qpos_mat(g):
        M = np.eye(19)
        M[:3, :3] = r3(g)
        return M

    data = {'qpos': qpos, 'base_pos': qpos[:, :3].copy(), 'base_lin_vel': rng.randn(5, 3),
            'feet_pos': rng.randn(5, 12), 'work': rng.randn(5, 1)}
    reps = {'qpos': _MirrorRep(G, qpos_mat), 'base_pos': r3, 'base_lin_vel': r3,
            'feet_pos': None, 'work': None}
    for fix_base in (False, True):
        got = symmetry.augment_obs_data(data, reps, fix_base=fix_base)
        want = jsym.augment_obs_data(data, reps, fix_base=fix_base)
        assert set(got) == set(want)
        for name in want:
            assert set(got[name]) == set(want[name]) == {'e', 's'}
            for g in ('e', 's'):
                if want[name][g] is None:
                    assert got[name][g] is None, (name, g)
                else:
                    np.testing.assert_allclose(got[name][g], want[name][g], rtol=0, atol=TOL,
                                               err_msg=f'{name} {g} fix_base={fix_base}')
    # the input is not written to
    assert np.array_equal(data['base_pos'], qpos[:, :3])


def test_reps_need_morpho_symm():
    with pytest.raises(ImportError, match='morpho_symm'):
        symmetry.configure_observation_space_representations('go2', ('qpos', 'qvel'))
    with pytest.raises(ImportError, match='morpho_symm'):
        jsym.configure_observation_space_representations('go2', ('qpos', 'qvel'))


def test_camera_save(tmp_path, monkeypatch):
    monkeypatch.delenv('GYM_QUADRUPED_ASSETS', raising=False)
    jm = jload('aliengo', 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    kw = dict(width=16, height=12, cam_name='robotcam')
    ref, port = jsen.Camera(jm, **kw), psen.Camera(dm, **kw)
    ref.shoot = jax.jit(ref.shoot)
    qpos = np.array(jm.key_qpos[0])
    qpos[3:7] = [0.995, 0.0, 0.05, 0.0]   # the horizon across the image: sky and floor
    qpos[3:7] /= np.linalg.norm(qpos[3:7])
    want = ref.save(tmp_path / 'ref', qpos)
    got = port.save(tmp_path / 'port', qpos)
    assert got.parent == tmp_path / 'port' and len(got.name) == len('20260101_000000')
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names == [
        'depth.npy', 'depth.png', 'points.npy', 'seg.npy']
    for name in ('depth.npy', 'points.npy', 'seg.npy'):
        g, w = np.load(got / name), np.load(want / name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=name)
    seg = np.load(got / 'seg.npy')
    assert (seg == -1).any() and (seg >= 0).any(), 'the image shows neither sky nor floor'
    g, w = (np.asarray(Image.open(d / 'depth.png'), np.int32) for d in (got, want))
    assert g.shape == w.shape == (12, 16)
    assert np.abs(g - w).max() <= 1
    # RGB renders the display model of the robot's MJCF, which aliengo lacks
    # here: the same exception as the reference's
    raised = []
    for name, cam in (('port', port), ('ref', ref)):
        with pytest.raises(Exception) as info:
            cam.save(tmp_path / f'rgb_{name}', qpos, rgb=True)
        raised.append(info.type)
    assert raised == [FileNotFoundError] * 2
