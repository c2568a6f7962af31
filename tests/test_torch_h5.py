"""The port's HDF5 store (utils/data/h5.py) and dataset adapter
(data/proprioceptive_datasets.py) against the JAX package's, on the CPU.

* A file written by the port equals the file the reference writes from the
  same recordings, in every dataset and attribute (class references
  included); each package reads the other's file, and the port resolves
  class references into its own package only.
* `append_batch` writes the same file as B calls of `append_trajectory`.
* `ProprioceptiveDataset` over one file against the reference's: the
  windows of both modes, from the file and loaded to memory, the `shuffle`
  order, the moments, `subset_dataset`, and the order of the batches.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.data import proprioceptive_datasets as jdata
from gym_quadruped_tpu.utils.data import h5 as jh5
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.data import ProprioceptiveDataset, slices_from_traj_len
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.utils.data import H5Reader, H5Writer
from gym_quadruped_tpu_torch.utils.data import h5 as ph5

OBS_DIMS = {'qpos': 19, 'qvel': 18, 'contact_state': 4}


def _hparams(sensors):
    return dict(robot='aliengo', scene='flat', state_obs_names=('qpos', 'qvel', 'contact_state'),
                sim_dt=0.002, ref_base_lin_vel=(0.0, 1.0), legs_order=('FL', 'FR', 'RL', 'RR'),
                sensors=sensors, sensors_kwargs=({'num_rows': 3}, {}), nested={'a': 1, 'b': 'x'},
                array=np.arange(3.0), external_disturbances_kwargs=None)


def _recordings(B=5, T=12, seed=0):
    rng = np.random.RandomState(seed)
    obs = {name: rng.randn(B, T, d).astype(np.float32) for name, d in OBS_DIMS.items()}
    obs['action'] = rng.uniform(-2, 2, (B, T, 12))
    obs['extra'] = rng.randn(B, T, 2, 3)
    return obs, 0.002 * np.arange(1, T + 1)


def _write(module, path, sensors, batch=True, torch_values=False):
    obs, time = _recordings()
    w = module.H5Writer(path, obs_dims=OBS_DIMS, action_dim=12, env_hparams=_hparams(sensors),
                        extra_obs={'extra': (2, 3)})
    if batch:
        w.append_batch({k: torch.as_tensor(v) if torch_values else v for k, v in obs.items()},
                       time)
    else:
        for b in range(len(obs['qpos'])):
            w.append_trajectory({k: v[b] for k, v in obs.items()}, time)
    return path


def _contents(path):
    """{name: (kind, value)} of every dataset and attribute in the file."""
    out = {}
    with h5py.File(path, 'r') as hf:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = ('dataset', obj.dtype.str, obj.maxshape, obj[()])
            for k, v in obj.attrs.items():
                out[f'{name}@{k}'] = ('attr', v)
        visit('/', hf)
        hf.visititems(visit)
    return out


def _assert_same_file(a, b):
    ca, cb = _contents(a), _contents(b)
    assert set(ca) == set(cb)
    for name in ca:
        va, vb = ca[name], cb[name]
        assert va[:-1] == vb[:-1], name
        np.testing.assert_array_equal(va[-1], vb[-1], err_msg=name)


def test_port_file_equals_reference_file(tmp_path):
    ours = _write(ph5, tmp_path / 'port.h5', (psen.HeightMap, psen.IMU), torch_values=True)
    ref = _write(jh5, tmp_path / 'ref.h5', (jsen.HeightMap, jsen.IMU))
    _assert_same_file(ours, ref)
    with h5py.File(ours, 'r') as hf:
        assert json.loads(hf['env_hparams'].attrs['sensors']) == [
            'TYPE:gym_quadruped_tpu.sensors.heightmap.HeightMap',
            'TYPE:gym_quadruped_tpu.sensors.imu.IMU']
    # each package reads the other's file: the classes resolve into the reader's package
    theirs = jh5.H5Reader(ours)
    assert theirs.env_hparams['sensors'] == [jsen.HeightMap, jsen.IMU]
    mine = H5Reader(ref)
    assert mine.env_hparams['sensors'] == [psen.HeightMap, psen.IMU]
    assert mine.n_trajectories == theirs.n_trajectories == mine.len() == 5
    for tid in range(5):
        (t0, d0), (t1, d1) = mine.get_trajectory(tid), theirs.get_trajectory(tid)
        np.testing.assert_array_equal(t0, t1)
        assert set(d0) == set(d1) == set(OBS_DIMS) | {'action', 'extra'}
        for k in d0:
            np.testing.assert_array_equal(d0[k], d1[k], err_msg=k)
    assert set(mine.env_hparams) == set(theirs.env_hparams)
    for k, v in mine.env_hparams.items():
        if k != 'sensors':
            np.testing.assert_equal(v, theirs.env_hparams[k], err_msg=k)
    mine.close()
    theirs.close()


def test_foreign_class_reference_is_refused(tmp_path):
    path = tmp_path / 'foreign.h5'
    with h5py.File(path, 'w') as hf:
        hf.create_group('env_hparams').attrs['sensors'] = json.dumps(['TYPE:os.path.join'])
        hf.create_group('recordings').create_dataset('time', shape=(0, 0, 1))
    with pytest.raises(ValueError, match='outside gym_quadruped_tpu_torch'):
        H5Reader(path)


def test_append_batch_equals_trajectories(tmp_path):
    batch = _write(ph5, tmp_path / 'batch.h5', (psen.HeightMap,))
    single = _write(ph5, tmp_path / 'single.h5', (psen.HeightMap,), batch=False)
    ref = _write(jh5, tmp_path / 'ref.h5', (jsen.HeightMap,), batch=False)
    _assert_same_file(batch, single)
    _assert_same_file(batch, ref)
    obs, time = _recordings()
    with pytest.raises(ValueError, match='inconsistent time steps'):
        H5Writer(tmp_path / 'bad.h5', obs_dims=OBS_DIMS).append_batch(
            {'qpos': obs['qpos'], 'qvel': obs['qvel'][:, :5]}, time)


def test_writer_from_env(tmp_path):
    env = QuadrupedEnv('go2', model=load_model('go2', 'flat', device='cpu'),
                       sensors=(psen.HeightMap,), state_obs_names=('qpos', 'height_map_z'))
    H5Writer(tmp_path / 'env.h5', env=env)
    r = H5Reader(tmp_path / 'env.h5')
    assert {k: r.recordings[k].shape for k in r.recordings} == {
        'time': (0, 0, 1), 'qpos': (0, 0, 19), 'height_map_z': (0, 0, 100), 'action': (0, 0, 12)}
    assert r.env_hparams['robot'] == 'go2' and r.env_hparams['scene'] == 'flat'
    r.close()


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        for g, w in ((gx, wx), (gy, wy)):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize('mode,memory', [('static', False), ('dynamic', False),
                                         ('static', True), ('dynamic', True)])
def test_dataset_matches_reference(tmp_path, mode, memory):
    path = _write(jh5, tmp_path / 'data.h5', (jsen.HeightMap,))
    args = (path, ['qpos', 'qvel'], ['contact_state'], 5, 2)
    kw = dict(mode=mode, load_to_memory=memory, dtype=torch.float64)
    ds, ref = ProprioceptiveDataset(*args, **kw), jdata.ProprioceptiveDataset(*args, **kw)
    assert len(ds) == len(ref) == 5 * (12 - (5 if mode == 'static' else 7) + 1)
    assert ds._indices == ref._indices and repr(ds) == repr(ref)
    _assert_items_equal(_items(ds), _items(ref))
    if memory:
        x0 = ds[0][0]['qpos']
        assert isinstance(x0, torch.Tensor) and x0.dtype == torch.float64

    state = np.random.get_state()
    ds.shuffle(3)
    assert np.array_equal(np.random.get_state()[1], state[1])   # numpy's global state untouched
    ref.shuffle(3)
    assert ds._indices == ref._indices
    _assert_items_equal(_items(ds), _items(ref))

    moments, ref_moments = ds.compute_obs_moments(), ref.compute_obs_moments()
    assert set(moments) == set(ref_moments) == {'qpos', 'qvel', 'contact_state'}
    for k, (mean, var) in moments.items():
        np.testing.assert_array_equal(mean, ref_moments[k][0], err_msg=k)
        np.testing.assert_array_equal(var, ref_moments[k][1], err_msg=k)

    sub, ref_sub = ds.subset_dataset([1, 3]), ref.subset_dataset([1, 3])
    assert sub._indices == ref_sub._indices and sub.n_trajectories == ref_sub.n_trajectories == 2
    _assert_items_equal(_items(sub), _items(ref_sub))
    for (mean, var), (rmean, rvar) in zip(sub.compute_obs_moments().values(),
                                          ref_sub.compute_obs_moments().values()):
        np.testing.assert_array_equal(mean, rmean)
        np.testing.assert_array_equal(var, rvar)

    batches = list(ds.as_batches(8, seed=2))
    ref_batches = list(ref.as_jax_batches(8, seed=2))
    assert len(batches) == len(ref_batches) == len(ds) // 8
    for (x, y), (rx, ry) in zip(batches, ref_batches):
        for got, want in ((x, rx), (y, ry)):
            for k, v in got.items():
                assert isinstance(v, torch.Tensor) and v.dtype == torch.float64
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_slices_and_arguments(tmp_path):
    assert [(s.start, s.stop) for s in slices_from_traj_len(10, 4, 2)] == \
        [(s.start, s.stop) for s in jdata.slices_from_traj_len(10, 4, 2)]
    path = _write(jh5, tmp_path / 'data.h5', (jsen.HeightMap,))
    with pytest.raises(ValueError, match='Mode'):
        ProprioceptiveDataset(path, ['qpos'], ['qvel'], mode='sideways')
    with pytest.raises(KeyError, match='depth'):
        ProprioceptiveDataset(path, ['depth'], ['qvel'])
    ds = ProprioceptiveDataset(path, ['qpos'], ['qvel'], 3, 1, load_to_memory=True)
    x, y = ds[0]
    assert x['qpos'].dtype == torch.float32 and x['qpos'].shape == (3, 19)
    assert y['qvel'].shape == (1, 18)
