"""The port's four example drives (gym_quadruped_tpu_torch/examples/) on the
CPU at a small size: the glue between the modules, whose parity with the
reference the module tests hold (test_torch_mpc_closed_loop.py,
test_torch_sensors.py, test_torch_h5.py).

* go2_mpc_locomotion at 0.02 s (10 steps, a cold solve and 2 warm
  replans): upright and finite, exactly 2 SPD and 1 Newton calls (their
  plain versions here) per env.step and none in a tick; the recording.
* aliengo_with_sensors: finite readings of the reference's shapes (IMU 3,
  heightmap 10 x 10, depth 48 x 64). Its random reset may leave the robot
  in free fall, so no value of the IMU is asserted.
* aliengo_dataset through its command line, 2 episodes x 12 steps: the H5
  file's datasets (their names and per-step shapes) and `env_hparams` equal
  those the reference's H5Writer writes for the same env config (no
  reference program is compiled); the read-back's env and window.
* dataset_reproduction at 20 steps: the rebuilt env's robot and scene, the
  replay's and the symmetry step's lines where GL, go2's MJCF and
  morpho_symm are missing.
* Importing a drive prints nothing.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env.env import QuadrupedEnv as JEnv
from gym_quadruped_tpu.utils.data import h5 as jh5
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.examples import (
    aliengo_dataset,
    aliengo_with_sensors,
    dataset_reproduction,
    go2_mpc_locomotion,
)
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.physics import engine

ROOT = Path(__file__).resolve().parents[1]
DRIVES = (go2_mpc_locomotion, aliengo_with_sensors, aliengo_dataset, dataset_reproduction)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_assets(monkeypatch):
    """No robot MJCF to be found: the replay fails before any renderer."""
    monkeypatch.delenv('GYM_QUADRUPED_ASSETS', raising=False)


def _counted(monkeypatch):
    """Count the calls of the two kernels' wrappers, and each env.step's."""
    counts = {'spd': 0, 'newton': 0, 'steps': []}
    spd, newton, step = engine.spd_solve_batched, nf.solve_batched, QuadrupedEnv.step

    def spd_counted(*a, **kw):
        counts['spd'] += 1
        return spd(*a, **kw)

    def newton_counted(*a, **kw):
        counts['newton'] += 1
        return newton(*a, **kw)

    def step_counted(self, *a, **kw):
        before = counts['spd'], counts['newton']
        out = step(self, *a, **kw)
        counts['steps'].append((counts['spd'] - before[0], counts['newton'] - before[1]))
        return out

    monkeypatch.setattr(engine, 'spd_solve_batched', spd_counted)
    monkeypatch.setattr(nf, 'solve_batched', newton_counted)
    monkeypatch.setattr(QuadrupedEnv, 'step', step_counted)
    return counts


def test_go2_mpc_locomotion(monkeypatch, tmp_path, capsys):
    counts = _counted(monkeypatch)
    out = go2_mpc_locomotion.main(seconds=0.02, record=str(tmp_path / 'trot.h5'), device='cpu')
    assert out['steps'] == 10 and out['solves'] == 2
    # the reset's step, then 2 SPD and 1 Newton per env.step, none in the 3 ticks
    assert counts['steps'] == [(2, 1)] * 10
    assert (counts['spd'], counts['newton']) == (2 * 11, 11)
    state = out['state']
    assert out['qpos'].shape == (10, 19) and out['vx'].shape == (10,)
    assert np.isfinite(out['qpos']).all() and torch.isfinite(out['tau']).all()
    np.testing.assert_array_equal(out['qpos'][-1], state.qpos[0].numpy())
    assert 0.2 < out['qpos'][:, 2].min() and out['qpos'][:, 2].max() < 0.4
    R22 = 1 - 2 * (state.qpos[0, 4] ** 2 + state.qpos[0, 5] ** 2)
    assert float(R22) > 0.9
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('10 steps + 2 MPC solves in ')
    assert lines[1].startswith(f'recorded to {tmp_path / "trot.h5"}')
    with h5py.File(tmp_path / 'trot.h5') as f:
        assert f['recordings/qpos'].shape == (1, 10, 19)
        np.testing.assert_array_equal(f['recordings/qpos'][0], out['qpos'])
        np.testing.assert_allclose(f['recordings/time'][0, :, 0], 0.002 * np.arange(10))


def test_aliengo_with_sensors(capsys):
    out = aliengo_with_sensors.main(device='cpu')
    obs = out['obs']
    for name, shape in (('imu_acc', (1, 3)), ('imu_gyro', (1, 3)), ('imu_acc_bias', (1, 3)),
                        ('height_map_z', (1, 100)), ('qpos', (1, 19))):
        assert obs[name].shape == shape and torch.isfinite(obs[name]).all(), name
    assert out['depth'].shape == out['seg'].shape == (48, 64)
    assert out['cloud'].shape == (48 * 64, 3)
    assert torch.isfinite(out['depth']).all() and bool((out['depth'] >= 0).all())
    assert bool((out['seg'] >= 0).any())
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines[:3]] == ['imu_acc', 'imu_gyro', 'height_map_z']
    assert any(line.startswith('depth image   (48, 64) range [') for line in lines)


def _h5_layout(path):
    """({dataset: (dtype, per-step shape)}, env_hparams) of an H5 file."""
    with h5py.File(path) as f:
        rec = f['recordings']
        return ({k: (rec[k].dtype.str, rec[k].shape[2:]) for k in rec},
                jh5.load_dict_from_h5(f['env_hparams']))


def test_aliengo_dataset_command_line(tmp_path):
    path = tmp_path / 'aliengo.h5'
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get('PYTHONPATH')] if p]), 'OMP_NUM_THREADS': '1'}
    run = subprocess.run([sys.executable, '-m', 'gym_quadruped_tpu_torch.examples.aliengo_dataset',
                          '--episodes', '2', '--steps', '12', '--path', str(path),
                          '--device', 'cpu'], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[0] == f'wrote 2 episodes × 12 steps to {path}'
    assert lines[2] == 'reconstructed env: aliengo / flat'
    assert lines[3] == '2 trajectories and 4 total samples. — x window qpos (10, 19), y (1, 4)'

    # the reference's writer for the same env config: its file holds no episode
    jenv = JEnv('aliengo', state_obs_names=aliengo_dataset.OBS, scene='flat',
                base_vel_command_type='random', ref_base_lin_vel=(-1.0, 1.0))
    jh5.H5Writer(tmp_path / 'ref.h5', env=jenv)
    got, want = _h5_layout(path), _h5_layout(tmp_path / 'ref.h5')
    assert got[0] == want[0] and set(got[0]) == {'time', 'action', *aliengo_dataset.OBS}
    assert got[1].keys() == want[1].keys()
    for k, v in want[1].items():
        assert np.array_equal(np.asarray(got[1][k]), np.asarray(v)), k
    with h5py.File(path) as f:
        assert all(f['recordings'][k].shape[:2] == (2, 12) for k in f['recordings'])
        times = f['recordings/time'][:, :, 0]
        np.testing.assert_allclose(times, 0.002 * np.arange(1, 13)[None].repeat(2, 0))
        assert np.abs(f['recordings/action'][:, 1:]).max() <= 5.0
        assert not f['recordings/action'][:, 0].any()


def test_dataset_reproduction(tmp_path, capsys, no_assets):
    env2, dataset = dataset_reproduction.main(steps=20, path=str(tmp_path / 'trot.h5'),
                                              device='cpu')
    assert (env2.robot_name, env2.scene_name) == ('go2', 'flat')
    assert env2.model.device.type == 'cpu' and env2.state_obs_names == dataset_reproduction.OBS
    assert len(dataset) == 20 - 12 + 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [f'recorded 20 steps of MPC trot to {tmp_path / "trot.h5"}',
                         'reconstructed env from file: go2/flat']
    assert lines[2].startswith('replay rendering unavailable here (FileNotFoundError)')
    assert lines[3] == 'morpho_symm not installed — skipping symmetry augmentation'
    assert lines[4].startswith('1 trajectories and 9 total samples.; qvel moments mean[:3] = ')
    with h5py.File(tmp_path / 'trot.h5') as f:
        rec = f['recordings']
        assert {k: rec[k].shape for k in rec} == {
            'time': (1, 20, 1), 'action': (1, 20, 12), 'qpos': (1, 20, 19),
            'qvel': (1, 20, 18), 'base_lin_vel': (1, 20, 3), 'contact_state': (1, 20, 4)}
        assert np.isfinite(rec['qpos'][:]).all() and rec['action'][0, 1:].any()


@pytest.mark.parametrize('drive', DRIVES, ids=lambda m: m.__name__.rsplit('.', 1)[1])
def test_import_runs_nothing(drive, capsys):
    importlib.reload(drive)
    assert capsys.readouterr().out == ''
    assert callable(drive.main)
