"""The port's QuadrupedEnv with sensors against the JAX package's, in f64.

aliengo/flat with an IMU and a HeightMap, the example's six observables.
The IMU's noise and bias rates are 0 where both packages step, so both
read the same numbers (their draws cannot agree: JAX keys against a
torch.Generator; test_torch_sensors.py holds the noise arithmetic on JAX's
own draws). The model's contact pairs are cut to those of the feet (the
plane-sphere and sphere-sphere groups) on both sides: the reference's env
program then compiles in ~20 s on one core instead of ~3.5 min, with the
same sensors and env code; the full narrow phase of aliengo is held by
test_torch_step_pyramidal.py.

* The observation dims and limits against the reference's.
* Reset with explicit qpos and qvel against `jax.vmap(env.reset)`: the
  sensors start and read once at the state before the refresh step; every
  state field, the sensor states and the observables, 1e-9.
* 20 `env.step` from the reference's reset state carried over by
  `state_from_numpy` (its sensor states too), both at a Newton cap of 30:
  qpos within 1e-3 and every observable within 1e-3 at every step, the
  existing env tests' tolerance.
* A noisy IMU: env.step without a generator raises; `quarantine_step`
  re-initialises a reset env's sensor states as `env.reset` does, from the
  same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.env.env import QuadrupedEnv as JEnv
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.env import EnvState, QuadrupedEnv
from gym_quadruped_tpu_torch.env.batch import quarantine_step
from gym_quadruped_tpu_torch.env.state import state_from_numpy, tensor_fields
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from test_torch_step import _close

OBS = ('qpos', 'qvel', 'imu_acc', 'imu_gyro', 'imu_acc_bias', 'height_map_z')
IMU_QUIET = dict(accel_noise=0.0, gyro_noise=0.0, accel_bias_rate=0.0, gyro_bias_rate=0.0)
CONFIG = dict(state_obs_names=OBS, base_vel_command_type='forward', ref_base_lin_vel=0.6,
              ground_friction_coeff=0.8, solver_iterations=30)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def aliengo():
    """(reference env, port env, reset program, step program) on aliengo/flat
    with its contact pairs cut to the feet's, compiled once."""
    jm = jload('aliengo', 'flat')
    feet = set(np.asarray(jm.feet_geom_id).tolist())
    jm = dataclasses.replace(jm, contact_pairs=np.array(
        [p for p in np.asarray(jm.contact_pairs) if int(p[1]) in feet]))
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    jenv = JEnv('aliengo', model=jm, sensors=(jsen.IMU, jsen.HeightMap),
                sensors_kwargs=(IMU_QUIET, {}), **CONFIG)
    env = QuadrupedEnv('aliengo', model=dm, sensors=(psen.IMU, psen.HeightMap),
                       sensors_kwargs=(IMU_QUIET, {}), **CONFIG)
    return (jenv, env, jax.jit(jax.vmap(lambda k, q, v: jenv.reset(k, qpos=q, qvel=v))),
            jax.jit(jax.vmap(jenv.step)))


def _start(jm, B, seed):
    """The keyframe with its feet on the floor (it stands 12.7 mm above it),
    joints +-0.05 rad off, small velocities."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 2] -= 0.0127 + rng.uniform(0.0, 0.005, B)
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, jm.nq - 7))
    return qpos, 0.1 * rng.randn(B, jm.nv)


def _check_state(state, ref, tol, where):
    for f in tensor_fields(EnvState):
        _close(getattr(state, f.name).double(), np.asarray(getattr(ref, f.name), np.float64), tol,
               f'{where} {f.name}')
    assert len(state.sensors) == len(ref.sensors) == 2
    for ss, rs in zip(state.sensors, ref.sensors):
        for f in dataclasses.fields(ss):
            _close(getattr(ss, f.name), np.asarray(getattr(rs, f.name)), tol,
                   f'{where} {type(ss).__name__}.{f.name}')


def _check_obs(obs, ref, tol, where):
    assert set(obs) == set(ref) == set(OBS)
    for name in OBS:
        _close(obs[name], np.asarray(ref[name]), tol, f'{where} obs {name}')


def test_observation_space(aliengo):
    jenv, env = aliengo[:2]
    assert env.observation_space_dims() == jenv.observation_space_dims()
    want = jenv.observation_space_limits()
    for name, (lo, hi) in env.observation_space_limits().items():
        np.testing.assert_array_equal(lo, want[name][0], err_msg=name)
        np.testing.assert_array_equal(hi, want[name][1], err_msg=name)
    assert env.observation_space_dims()['height_map_z'] == 100


def test_reset_reads_sensors(aliengo):
    jenv, env, jreset = aliengo[:3]
    B = 3
    qpos, qvel = _start(jenv.model, B, seed=1)
    ref_state, ref_obs = jreset(jax.random.split(jax.random.PRNGKey(1), B), qpos, qvel)
    state, obs = env.reset(torch.Generator().manual_seed(1), B, qpos=torch.as_tensor(qpos),
                           qvel=torch.as_tensor(qvel))
    _check_state(state, ref_state, 1e-9, 'reset')
    _check_obs(obs, ref_obs, 1e-9, 'reset')
    assert bool(obs['imu_acc'].isfinite().all()) and bool((obs['height_map_z'] == 0).all())


def test_trajectory_20_steps(aliengo):
    jenv, env, jreset, jstep = aliengo
    B, T = 3, 20
    qpos, qvel = _start(jenv.model, B, seed=2)
    ref_state, _ = jreset(jax.random.split(jax.random.PRNGKey(2), B), qpos, qvel)
    state = state_from_numpy(jax.tree.map(np.asarray, ref_state), 'cpu', torch.float64)
    assert [type(ss) for ss in state.sensors] == [psen.IMUState, psen.HeightMapState]
    actions = np.random.RandomState(3).uniform(-2, 2, (T, B, jenv.model.nu))
    for t in range(T):
        ref_state, ref_obs, *_ = jstep(ref_state, jnp.asarray(actions[t]))
        state, obs, *_ = env.step(state, torch.as_tensor(actions[t]))
        _check_obs(obs, ref_obs, 1e-3, f'step {t}')
    err = np.abs(state.qpos.numpy() - np.asarray(ref_state.qpos)).max()
    assert err < 1e-3, err
    assert bool(torch.isfinite(obs['imu_acc']).all())


def test_noisy_imu_and_quarantine(aliengo):
    """With the IMU's default noise: a step without a generator raises; a
    diverged env's sensor states are those of a fresh reset from the same
    draws, the other envs' those of the plain step."""
    env = aliengo[1]
    noisy = QuadrupedEnv('aliengo', model=env.model, sensors=(psen.IMU, psen.HeightMap),
                         **CONFIG)
    B = 4
    qpos, qvel = _start(env.model.m, B, seed=4)
    gen = torch.Generator().manual_seed(5)
    state, _ = noisy.reset(gen, B, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
    action = torch.zeros(B, env.model.m.nu, dtype=torch.float64)
    with pytest.raises(ValueError, match='generator'):
        noisy.step(state, action)
    qv = state.qvel.clone()
    qv[1, 3] = float('nan')
    bad = dataclasses.replace(state, qvel=qv)
    replay = torch.Generator().manual_seed(5)
    replay.set_state(gen.get_state())
    out = quarantine_step(noisy, bad, action, gen)
    plain = noisy.step(bad, action, replay)[0]
    fresh = noisy.reset(replay, 1)[0]
    assert int(out[5]['quarantined']) == 1 and out[0].step_num.tolist() == [1, 0, 1, 1]
    for got, step_ss, fresh_ss in zip(out[0].sensors, plain.sensors, fresh.sensors):
        for f in dataclasses.fields(got):
            x = getattr(got, f.name)
            assert torch.equal(x[1], getattr(fresh_ss, f.name)[0]), f.name
            assert torch.equal(x[[0, 2, 3]], getattr(step_ss, f.name)[[0, 2, 3]]), f.name
    imu = out[0].sensors[0]
    assert bool((imu.acc_bias[1] != plain.sensors[0].acc_bias[1]).any())
