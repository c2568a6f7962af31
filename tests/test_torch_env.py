"""The port's env layer against the JAX package's QuadrupedEnv, in f64.

The port draws from a torch.Generator and cannot reproduce JAX's streams,
so every comparison starts both envs from the same numbers: explicit qpos
and qvel with scalar ranges and single-value disturbances (a deterministic
reset), or one state fed to both (`state_from_numpy`).

* `obs_dim` and `obs_limits` of all 31 observables (spot, aliengo).
* Reset with explicit qpos and qvel against `jax.vmap(env.reset)`: every
  state field and all 31 observables, 1e-9.
* One step from a state with per-env friction, a fixed disturbance wrench
  and a forward+rotate command against `jax.vmap(env.step)`: state, all 31
  observables, termination and info, 1e-9.
* 200 steps on spot/flat from such a state, seeded U(-2, 2) torques: within
  1e-3 in qpos (aliengo/flat's 20 at the step's cap of 10:
  test_torch_step_pyramidal.py).
* `_lift_until_no_contact` on seeded lowered states against the
  reference's, 1e-9; a random reset held to the reference's ranges.
* Callable commands (as tests/test_commands.py holds the reference) and the
  'reset' cadence of commands and disturbances.

The env steps of the single-call comparisons run the Newton solve with a
cap of 30 iterations on both sides (`solver_iterations`), so that it
converges: a solve stopped at the step's cap of 10 ends ~1e-8-1e-5 apart
between two programs of the reference itself (test_torch_env_physics.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env.env import QuadrupedEnv as JEnv
from gym_quadruped_tpu.env.state import EnvState as JEnvState
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu_torch.env import ALL_OBS, EnvState, QuadrupedEnv, init_state
from gym_quadruped_tpu_torch.env import observables as pobs
from gym_quadruped_tpu_torch.env.state import state_from_numpy, tensor_fields
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics.kinematics import fk as pfk
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz
from test_torch_mixed import fast_jit
from test_torch_step import _close

# deterministic commands and disturbances: scalar ranges, single values
CONFIG = dict(state_obs_names=ALL_OBS, base_vel_command_type='forward+rotate',
              ref_base_lin_vel=0.6, ref_base_ang_vel=0.2, ground_friction_coeff=0.8,
              external_disturbances_kwargs={'x': (4.0,), 'yaw': (0.5,)})
CONVERGED = 30


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(jm):
    return to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                     'cpu', torch.float64)


@pytest.fixture(scope='module')
def spot():
    """(reference env, port env, reset program, step program, lift program)
    on spot/flat, compiled once for the module."""
    jm = jload('spot', 'flat')
    jenv = JEnv('spot', model=jm, solver_iterations=CONVERGED, **CONFIG)
    env = QuadrupedEnv('spot', model=_port_model(jm), solver_iterations=CONVERGED, **CONFIG)
    return (jenv, env,
            fast_jit(jax.vmap(lambda k, q, v: jenv.reset(k, qpos=q, qvel=v))),
            fast_jit(jax.vmap(jenv.step)),
            fast_jit(jax.vmap(jenv._lift_until_no_contact)))


def _arrays(m, B, seed, press=0.0):
    """The fields of B seeded states: the keyframe `press` and U(0, 5) mm
    lower, joints +-0.05 rad off, small velocities, a per-env friction
    table, a fixed wrench and command."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 2] -= press + rng.uniform(0.0, 0.005, B)
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, m.nq - 7))
    fric = np.tile(m.geom_friction, (B, 1, 1))
    fric[:, :, 0] *= rng.uniform(0.5, 1.5, (B, 1))
    return dict(
        qpos=qpos, qvel=0.1 * rng.randn(B, m.nv), ctrl=np.zeros((B, m.nu)),
        qacc=np.zeros((B, m.nv)), time=np.full(B, m.timestep),
        step_num=np.zeros(B, np.int32),
        ref_base_lin_vel_H=np.tile([0.6, 0.0, 0.0], (B, 1)),
        ref_base_ang_yaw_dot=np.full(B, 0.2),
        steps_until_resample_vel=np.full(B, -1, np.int32),
        external_wrench=np.tile([4.0, 0, 0, 0, 0, 0.5], (B, 1)),
        steps_until_resample_wrench=np.full(B, -1, np.int32), geom_friction=fric)


def _both(arrays):
    """The same state for the reference (batched, with keys) and the port."""
    B = len(arrays['qpos'])
    ref = JEnvState(rng=jax.random.split(jax.random.PRNGKey(0), B), sensors=(),
                    **{k: jnp.asarray(v) for k, v in arrays.items()})
    return ref, state_from_numpy(arrays, 'cpu', torch.float64)


def _check_state(state, ref, tol, where):
    assert state.sensors == () and tuple(ref.sensors) == ()
    for f in tensor_fields(EnvState):
        got, want = getattr(state, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert got.shape == want.shape, f'{where} {f.name}: {got.shape} {want.shape}'
        if want.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, want, err_msg=f'{where} {f.name}')
        else:
            _close(got, want, tol, f'{where} {f.name}')


def _check_obs(obs, ref, tol, where):
    assert set(obs) == set(ref) == set(ALL_OBS)
    for name in ALL_OBS:
        _close(obs[name], np.asarray(ref[name]), tol, f'{where} obs {name}')


@pytest.mark.parametrize('robot', ['spot', 'aliengo'])
def test_obs_dims_and_limits(robot):
    from gym_quadruped_tpu.env import observables as jobs
    jm = jload(robot, 'flat')
    m = _port_model(jm).m
    assert len(ALL_OBS) == 31 and ALL_OBS == jobs.ALL_OBS
    for name in ALL_OBS + ['gravity_vector', 'imu_acc']:
        assert pobs.obs_dim(m, name) == jobs.obs_dim(jm, name), name
        for got, want in zip(pobs.obs_limits(m, name), jobs.obs_limits(jm, name)):
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError):
        pobs.obs_dim(m, 'base_height')


def test_init_state_matches_reference(spot):
    from gym_quadruped_tpu.env.state import init_state as jinit
    jenv, env = spot[:2]
    ref = jax.vmap(lambda k: jinit(jenv.model, k))(jax.random.split(jax.random.PRNGKey(0), 3))
    _check_state(init_state(env.model, 3), ref, 0.0, 'init_state')
    _check_state(state_from_numpy(ref, 'cpu', torch.float64), ref, 0.0, 'state_from_numpy')


def test_reset_explicit_matches_reference(spot):
    jenv, env, jreset = spot[:3]
    a = _arrays(jenv.model, 4, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    ref_state, ref_obs = jreset(keys, a['qpos'], a['qvel'])
    state, obs = env.reset(torch.Generator().manual_seed(1), 4, qpos=torch.as_tensor(a['qpos']),
                           qvel=torch.as_tensor(a['qvel']))
    _check_state(state, ref_state, 1e-9, 'reset')
    _check_obs(obs, ref_obs, 1e-9, 'reset')


def test_step_matches_reference(spot):
    jenv, env, _, jstep = spot[:4]
    a = _arrays(jenv.model, 4, seed=2)
    a['steps_until_resample_vel'][:] = 5     # no 'reset' type: never resampled
    ref_state, state = _both(a)
    action = np.random.RandomState(3).uniform(-2, 2, (4, jenv.model.nu))
    ref = jstep(ref_state, jnp.asarray(action))
    got = env.step(state, torch.as_tensor(action))
    _check_state(got[0], ref[0], 1e-9, 'step')
    _check_obs(got[1], ref[1], 1e-9, 'step')
    for i, name in ((2, 'reward'), (3, 'terminated'), (4, 'truncated')):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=name)
    assert set(got[5]) == set(ref[5])
    for k in got[5]:
        _close(got[5][k].double(), np.asarray(ref[5][k], np.float64), 1e-12, f'info {k}')
    assert bool(got[1]['contact_state'].any()), 'no foot touches the floor'
    # the disturbance moved the state: the same step without it differs
    plain = QuadrupedEnv('spot', model=env.model, solver_iterations=CONVERGED,
                         **{**CONFIG, 'external_disturbances_kwargs': None})
    assert not torch.allclose(plain.step(state, torch.as_tensor(action))[0].qvel, got[0].qvel)


def _trajectory(jstep, env, arrays, T, seed):
    """The reference's batched step program `jstep` and the port's env
    stepped T times from one state with seeded U(-2, 2) torques: the max
    |qpos| difference at the end."""
    ref_state, state = _both(arrays)
    actions = np.random.RandomState(seed).uniform(-2, 2, (T,) + arrays['ctrl'].shape)
    touched = 0
    for t in range(T):
        ref_state = jstep(ref_state, jnp.asarray(actions[t]))[0]
        state, obs, *_ = env.step(state, torch.as_tensor(actions[t]))
        touched += int(obs['contact_state'].sum())
    assert np.isfinite(state.qpos.numpy()).all()
    assert touched > 0, 'the trajectory never touched the floor'
    return np.abs(state.qpos.numpy() - np.asarray(ref_state.qpos)).max()


def test_trajectory_200_steps_spot(spot):
    """With a per-env friction table and a disturbance, through the
    module's step program (its Newton cap of 30: the step's own cap of 10
    holds aliengo's env trajectory, test_torch_step_pyramidal.py)."""
    jenv, env, _, jstep = spot[:4]
    err = _trajectory(jstep, env, _arrays(jenv.model, 4, seed=4), 200, seed=5)
    assert err < 1e-3, err


def test_lift_matches_reference(spot):
    jenv, env, _, _, jlift = spot
    m = jenv.model
    rng = np.random.RandomState(8)
    B = 6
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.08, B)        # up to 8 cm into the floor
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, m.nq - 7))
    qpos[0, 2] += 0.5                              # env 0 starts clear of it
    got, rounds = env._lift_until_no_contact(torch.as_tensor(qpos))
    _close(got, np.asarray(jlift(qpos)), 1e-9, 'lift')
    assert rounds >= 1 and got[0, 2] == qpos[0, 2]
    assert not bool(env._feet_penetration(got)[0].any())


def test_random_reset_ranges(spot):
    env = spot[1]
    m = env.model.m
    gen = torch.Generator().manual_seed(9)
    B = 16
    opts = {'angle_sweep': 0.2, 'roll_sweep': 0.1, 'pitch_sweep': 0.05}
    qpos, qvel = env._randomize_qpos(gen, B, opts)
    key = torch.as_tensor(m.key_qpos[0])
    assert bool(((qpos[:, 7:] - key[7:]).abs() <= 0.2).all())
    assert bool((qvel[:, :6] == 0).all() and (qvel[:, 6:].abs() <= 0.5).all())
    x_max, x_min, y_max, y_min = m.terrain_limits
    assert bool(((qpos[:, 0] >= min(x_min, x_max)) & (qpos[:, 0] <= max(x_min, x_max))).all())
    assert bool(((qpos[:, 1] >= min(y_min, y_max)) & (qpos[:, 1] <= max(y_min, y_max))).all())
    assert bool((qpos[:, 2] == m.hip_height).all())
    euler = quat_to_euler_xyz(qpos[:, 3:7])
    assert bool((euler[:, 0].abs() <= 0.1).all() and (euler[:, 1].abs() <= 0.05).all())
    _close(euler[:, 2], np.arctan2(-qpos[:, 1].numpy(), -qpos[:, 0].numpy()), 1e-12, 'yaw')
    lifted, _ = env._lift_until_no_contact(qpos)
    assert not bool(env._feet_penetration(lifted)[0].any())
    # the whole reset: a random pose out of contact, one zero-torque step
    state, obs = env.reset(gen, B, options=opts)
    assert bool(torch.isfinite(state.qpos).all()) and bool((state.ctrl == 0).all())
    assert bool((state.time == m.timestep).all() and (state.step_num == 0).all())
    assert not bool(obs['contact_state'].any())


def test_callable_velocity_commands():
    def lin(t):
        return np.array([0.2 + 0.1 * t, 0.05, 0.0])

    def ang(t):
        return 0.3 - 0.05 * t

    jm = jload('spot', 'flat')
    env = QuadrupedEnv('spot', model=_port_model(jm), ref_base_lin_vel=lin, ref_base_ang_vel=ang)
    jenv = JEnv('spot', model=jm, ref_base_lin_vel=lin, ref_base_ang_vel=ang)
    np.testing.assert_array_equal(env._lin_vel_table.numpy(), np.asarray(jenv._lin_vel_table))
    np.testing.assert_array_equal(env._ang_vel_table.numpy(), np.asarray(jenv._ang_vel_table))
    state, _ = env.reset(torch.Generator().manual_seed(10), 2)
    np.testing.assert_allclose(state.ref_base_lin_vel_H.numpy(), np.tile(lin(0.0), (2, 1)))
    assert bool((state.steps_until_resample_vel == -1).all())
    for _ in range(3):
        state, *_ = env.step(state, torch.zeros(2, jm.nu))
    t = float(state.time[0])
    np.testing.assert_allclose(state.ref_base_lin_vel_H.numpy(), np.tile(lin(t), (2, 1)),
                               atol=1e-12)
    np.testing.assert_allclose(state.ref_base_ang_yaw_dot.numpy(), [ang(t)] * 2, atol=1e-12)


def test_reset_cadence():
    """'reset' types resample an env's command and wrench when its counter
    reaches 1, and count down otherwise; the draws stay in their ranges."""
    jm = jload('spot', 'flat')
    env = QuadrupedEnv('spot', model=_port_model(jm), state_obs_names=('qpos',),
                       base_vel_command_type='random+rotate+reset', ref_base_lin_vel=(0.2, 1.0),
                       ref_base_ang_vel=(-0.5, 0.5),
                       external_disturbances_kwargs={'x': (-5.0, 5.0), 'z': (2.0,),
                                                     'type': 'reset'})
    gen = torch.Generator().manual_seed(11)
    state, _ = env.reset(gen, 4)
    for steps in (state.steps_until_resample_vel, state.steps_until_resample_wrench):
        assert bool(((steps >= 1000) & (steps < 3000)).all())
    counters = torch.tensor([1, 2, 3, 1500], dtype=torch.int32)
    state = dataclasses.replace(state, steps_until_resample_vel=counters.clone(),
                                steps_until_resample_wrench=counters.flip(0).clone())
    action = torch.zeros(4, jm.nu)
    with pytest.raises(ValueError, match='generator'):
        env.step(state, action)
    new = env.step(state, action, gen)[0]
    hit_v, hit_w = counters == 1, counters.flip(0) == 1
    for new_steps, old_steps, hit in ((new.steps_until_resample_vel, counters, hit_v),
                                      (new.steps_until_resample_wrench, counters.flip(0), hit_w)):
        assert bool((new_steps[~hit] == old_steps[~hit] - 1).all())
        assert bool(((new_steps[hit] >= 1000) & (new_steps[hit] < 3000)).all())
    same = lambda a, b, hit: bool((a[~hit] == b[~hit]).all())
    assert same(new.ref_base_lin_vel_H, state.ref_base_lin_vel_H, hit_v)
    assert same(new.ref_base_ang_yaw_dot, state.ref_base_ang_yaw_dot, hit_v)
    assert same(new.external_wrench, state.external_wrench, hit_w)
    speed = torch.linalg.vector_norm(new.ref_base_lin_vel_H, dim=-1)
    assert bool(((speed >= 0.2) & (speed <= 1.0)).all())
    assert bool((new.ref_base_ang_yaw_dot.abs() <= 0.5).all())
    wrench = new.external_wrench
    assert bool((wrench[:, 0].abs() <= 5.0).all() and (wrench[:, 2] == 2.0).all())
    assert bool((wrench[:, [1, 3, 4, 5]] == 0).all())


def test_sensors_not_ported(monkeypatch, tmp_path):
    """What raises with sensors, as in the reference: the camera's RGB
    `image` and `save(rgb=True)` (a host MuJoCo render of the display
    model) where the robot's MJCF is not to be found (aliengo has none in
    the repository), and an observable that neither the env nor a sensor
    knows."""
    from gym_quadruped_tpu.sensors import Camera as JCamera
    from gym_quadruped_tpu_torch.models.model import load_model
    from gym_quadruped_tpu_torch.sensors import Camera, HeightMap
    monkeypatch.delenv('GYM_QUADRUPED_ASSETS', raising=False)
    dm = load_model('aliengo', 'flat', device='cpu', dtype=torch.float64)
    cam = Camera(dm, 8, 6, cam_name='robotcam')
    ref = JCamera(jload('aliengo', 'flat'), 8, 6, cam_name='robotcam')
    # the reference's depth files from the port's cast: only `image` is at stake
    ref.shoot = lambda q: tuple(x[0].numpy() for x in cam.shoot(torch.as_tensor(q)[None]))
    qpos = torch.as_tensor(dm.m.key_qpos[:1])
    assert cam.depth_image(pfk(dm, qpos)).shape == (1, 6, 8)
    raised = []
    for c, q in ((cam, qpos[0]), (ref, dm.m.key_qpos[0])):
        for call in (lambda: c.image(q), lambda: c.save(tmp_path, q, rgb=True)):
            with pytest.raises(Exception) as e:
                call()
            raised.append(e.type)
    assert raised == [FileNotFoundError] * 4
    with pytest.raises(ValueError, match='height_map_x'):
        QuadrupedEnv('aliengo', model=dm, sensors=[HeightMap],
                     state_obs_names=('qpos', 'height_map_z', 'height_map_x'))
