"""The port's checkpoints (utils/checkpoint.py) on the CPU: a round trip bit
for bit with sensor states and the generator, a mixed batch's state tuple,
a checkpoint that the JAX package's `checkpoint.save` wrote restored into
the port, and KeyError on a missing leaf or a wrong shape."""

import dataclasses

import numpy as np
import pytest
import torch

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.env.state import EnvState as JState
from gym_quadruped_tpu.utils import checkpoint as jcheckpoint
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.env.state import state_from_numpy
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.utils import checkpoint
from gym_quadruped_tpu_torch.utils.tree import leaves_with_path, map_with_path

SENSORS = (psen.IMU, psen.HeightMap, psen.Camera)
SENSORS_KW = ({}, {'num_rows': 3, 'num_cols': 4}, {'width': 4, 'height': 3, 'cam_name': 'robotcam'})


def _state(robot, B, seed, n_sensors=3):
    """B envs of `robot` (f32, CPU) reset at the keyframe and stepped once,
    with the first n_sensors of the noisy IMU, the heightmap and the camera
    (aliengo's robotcam)."""
    env = QuadrupedEnv(robot, model=load_model(robot, 'flat', device='cpu'),
                       sensors=SENSORS[:n_sensors], sensors_kwargs=SENSORS_KW[:n_sensors],
                       ground_friction_coeff=(0.5, 1.5))
    gen = torch.Generator().manual_seed(seed)
    state, _ = env.reset(gen, B, qpos=torch.as_tensor(env.model.m.key_qpos[0]))
    return env.step(state, torch.rand(B, env.model.m.nu, generator=gen), gen)[0]


def _zeros_like(tree):
    return map_with_path(lambda _, x: torch.zeros_like(x), tree)


def _assert_equal(got, want):
    got, want = leaves_with_path(got), leaves_with_path(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device, key
        assert torch.equal(g, w), key


@pytest.fixture(scope='module')
def aliengo_state():
    return _state('aliengo', 3, 1)


def test_round_trip_with_sensors_and_generator(tmp_path, aliengo_state):
    path = tmp_path / 'ckpt.npz'
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)
    checkpoint.save(path, aliengo_state, gen)
    after_save = torch.rand(4, generator=gen)
    assert [type(ss) for ss in aliengo_state.sensors] == [psen.IMUState, psen.HeightMapState,
                                                      psen.CameraState]
    fresh = torch.Generator().manual_seed(123)
    restored = checkpoint.restore(path, _zeros_like(aliengo_state), fresh)
    _assert_equal(restored, aliengo_state)
    assert restored.sensors[2].seg.dtype == torch.int32 and restored.step_num.dtype == torch.int32
    assert torch.equal(torch.rand(4, generator=fresh), after_save)
    # each leaf takes `like`'s dtype
    like64 = aliengo_state.to('cpu', torch.float64)
    restored64 = checkpoint.restore(path, like64)
    assert restored64.qpos.dtype == torch.float64
    assert torch.equal(restored64.qpos, aliengo_state.qpos.double())


def test_mixed_state_tuple(tmp_path, aliengo_state):
    state = (_state('go2', 2, 2, n_sensors=2), aliengo_state)
    path = tmp_path / 'mixed.npz'
    checkpoint.save(path, state)
    with np.load(path) as data:
        keys = set(data.files)
    assert {'[0].qpos', '[1].qvel', '[0].sensors[1].points', '[1].sensors[2].seg'} <= keys
    assert checkpoint.GENERATOR_KEY not in keys
    _assert_equal(checkpoint.restore(path, _zeros_like(state)), state)
    with pytest.raises(KeyError, match='no generator state'):
        checkpoint.restore(path, _zeros_like(state), torch.Generator())


def _reference_state(B, seed):
    """A reference EnvState of B envs with numpy leaves (PRNG keys included,
    the state's and the IMU's), with an IMU and a HeightMap."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(B, *s)
    i = lambda *s: rng.randint(-1, 3000, (B, *s)).astype(np.int32)
    key = lambda: rng.randint(0, 2**31, (B, 2)).astype(np.uint32)
    imu = jsen.IMUState(rng=key(), acc=f(3), acc_noise=f(3), acc_bias=f(3), gyro=f(3),
                        gyro_noise=f(3), gyro_bias=f(3))
    hm = jsen.HeightMapState(points=f(3, 4, 3))
    return JState(qpos=f(19), qvel=f(18), ctrl=f(12), qacc=f(18), time=f(), step_num=i(),
                  rng=key(), ref_base_lin_vel_H=f(3), ref_base_ang_yaw_dot=f(),
                  steps_until_resample_vel=i(), external_wrench=f(6),
                  steps_until_resample_wrench=i(), geom_friction=f(40, 3), sensors=(imu, hm))


def test_reference_checkpoint_restores(tmp_path):
    ref = (_reference_state(2, 3), _reference_state(3, 4))
    path = tmp_path / 'reference.npz'
    jcheckpoint.save(path, ref)
    with np.load(path) as data:
        assert {'[0].rng', '[1].sensors[0].rng'} <= set(data.files)   # not read by the port
    want = tuple(state_from_numpy(s, 'cpu', torch.float64) for s in ref)
    restored = checkpoint.restore(path, _zeros_like(want))
    _assert_equal(restored, want)
    assert [type(ss) for ss in restored[1].sensors] == [psen.IMUState, psen.HeightMapState]
    one = tmp_path / 'one.npz'
    jcheckpoint.save(one, ref[0])
    _assert_equal(checkpoint.restore(one, _zeros_like(want[0])), want[0])


def test_key_errors(tmp_path, aliengo_state):
    path = tmp_path / 'ckpt.npz'
    checkpoint.save(path, aliengo_state)
    wider = dataclasses.replace(aliengo_state, qpos=torch.zeros(3, 20))
    with pytest.raises(KeyError, match=r'\.qpos shape'):
        checkpoint.restore(path, wider)
    more = dataclasses.replace(aliengo_state,
                               sensors=aliengo_state.sensors + aliengo_state.sensors[1:2])
    with pytest.raises(KeyError, match=r'missing leaf \.sensors\[3\]\.points'):
        checkpoint.restore(path, more)
