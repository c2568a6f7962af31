"""The port's single-env gym adapter against the JAX package's, in f64.

Both `QuadrupedGymEnv`s run go2/flat with its contact pairs cut to the
feet's on both sides (as tests/test_torch_env_sensors.py does, so that the
reference compiles no full-pair program) and a Newton cap of 30. The
reference's three programs (its reset to a given state, its step and its
Forward refresh) are compiled at `FAST_COMPILE`, side by side where the
cores allow.

* The reset is deterministic: explicit qpos and qvel with `random=False`
  and scalar command and friction ranges; its observations to 1e-9. The
  port's state is then set from the reference's through `state_from_numpy`
  and 3 steps of seeded torques follow: observations, reward, flags and
  info to 1e-9, with the reference's types.
* Every accessor of the reference's surface, in each frame, to 1e-9.
* `_key_callback` for each keycode, and the clips; the gym spaces; a
  seeded random reset repeats; without go2's MJCF `render` raises what the
  reference's raises, and `close` is safe before any viewer opened
  (tests/test_torch_render.py holds the viewer against the reference).
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env import gym_adapter as jgym
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import engine as jengine
from gym_quadruped_tpu_torch.env.gym_adapter import QuadrupedGymEnv
from gym_quadruped_tpu_torch.env.state import state_from_numpy
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from test_torch_mixed import FAST_COMPILE

TOL = 1e-9
OBS = ('qpos', 'qvel', 'feet_pos:base', 'contact_state', 'base_lin_vel_err', 'work')
CONFIG = dict(robot='go2', scene='flat', state_obs_names=OBS, base_vel_command_type='forward',
              ref_base_lin_vel=0.4, ground_friction_coeff=0.8, solver_iterations=30)
N_STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fast(jenv):
    """The reference adapter's reset-to-state, step and Forward programs
    compiled at `FAST_COMPILE`, side by side where the cores allow."""
    m = jenv.core.model
    key = jax.random.PRNGKey(0)
    qp, qv, ctrl = jnp.zeros(m.nq), jnp.zeros(m.nv), jnp.zeros(m.nu)
    reset = jax.jit(lambda k, q, v: jenv.core.reset(k, qpos=q, qvel=v))
    state = jax.eval_shape(reset, key, qp, qv)[0]
    step = jax.jit(jenv.core.step)
    forward = jax.jit(lambda q, v, c: jengine.forward(m, q, v, c))
    lowered = (reset.lower(key, qp, qv), step.lower(state, ctrl), forward.lower(qp, qv, ctrl))
    with ThreadPoolExecutor(min(3, len(os.sched_getaffinity(0)))) as pool:
        jenv._jit_reset_to, jenv._jit_step, jenv._jit_forward = pool.map(
            lambda p: p.compile(compiler_options=FAST_COMPILE), lowered)


@pytest.fixture(scope='module')
def envs():
    """(reference adapter, port adapter, reset observations, steps), both
    reset to the same state and stepped N_STEPS times with the same
    torques; each step's (obs, reward, terminated, truncated, info) of
    both."""
    jm = jload('go2', 'flat')
    feet = set(np.asarray(jm.feet_geom_id).tolist())
    jm = dataclasses.replace(jm, contact_pairs=np.array(
        [p for p in np.asarray(jm.contact_pairs) if int(p[1]) in feet]))
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    jenv = jgym.QuadrupedGymEnv(model=jm, **CONFIG)
    env = QuadrupedGymEnv(model=dm, **CONFIG)
    _fast(jenv)
    rng = np.random.RandomState(5)
    qpos = np.array(jm.key_qpos[0])
    qpos[2] -= 0.004
    qpos[7:] += rng.uniform(-0.05, 0.05, jm.nq - 7)
    qvel = 0.1 * rng.randn(jm.nv)
    obs = (jenv.reset(qpos=qpos, qvel=qvel, random=False, seed=1),
           env.reset(qpos=qpos, qvel=qvel, random=False, seed=1))
    # carry the reference's state over: both step from the same numbers
    env._state = state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], jenv._state),
                                  'cpu', torch.float64)
    steps = []
    for _ in range(N_STEPS):
        a = rng.uniform(-2, 2, jm.nu)
        steps.append((jenv.step(a), env.step(a)))
    return jenv, env, obs, steps


def _same(got, want, where):
    """got equal to want: numpy arrays to TOL, LegsAttr leg by leg, tuples
    and dicts item by item, Python scalars of the same type."""
    if type(want).__name__ == 'LegsAttr':
        assert type(got).__name__ == 'LegsAttr', where
        for leg in ('FL', 'FR', 'RL', 'RR'):
            _same(getattr(got, leg), getattr(want, leg), f'{where}.{leg}')
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f'{where}[{i}]')
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f'{where}[{k}]')
    elif want is None or isinstance(want, (bool, str)):
        assert got == want and type(got) is type(want), (where, got, want)
    elif isinstance(want, (float, int)):
        assert type(got) is type(want), (where, type(got), type(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=where)
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape, (where, got, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=where)


def test_reset_obs(envs):
    _, _, (want, got), _ = envs
    assert list(got) == list(OBS) and set(want) == set(OBS)
    _same(got, {k: np.asarray(v) for k, v in want.items()}, 'reset obs')


@pytest.mark.parametrize('t', range(N_STEPS))
def test_step(envs, t):
    want, got = envs[3][t]
    _same(got, want, f'step {t}')


# the accessors, each with its arguments: properties as None
ACCESSORS = [
    ('qpos', None), ('qvel', None), ('base_pos', None), ('base_ori_quat_wxyz', None),
    ('simulation_dt', None), ('simulation_time', None), ('legs_qvel_idx', None),
    ('legs_qpos_idx', None), ('legs_tau_idx', None), ('torque_ctrl_setpoint', None),
    ('base_configuration', None), ('heading_orientation_SO3', None),
    ('base_ori_euler_xyz', None), ('gravity_vector', None), ('joint_space_state', None),
    ('kinetic_energy', None), ('work', None), ('legs_mass_matrix', None),
    ('legs_qfrc_bias', None), ('legs_qfrc_passive', None), ('com', None),
    ('feet_pos', ('world',)), ('feet_pos', ('base',)),
    ('feet_jacobians', ('world',)), ('feet_jacobians', ('base',)),
    ('feet_jacobians_dot', ('world',)), ('feet_jacobians_dot', ('base',)),
    ('feet_vel', ('world', False)), ('feet_vel', ('base', False)),
    ('feet_vel', ('world', True)), ('feet_vel', ('base', True)),
    ('hip_positions', ('world',)), ('hip_positions', ('base',)),
    ('get_base_inertia', ()), ('base_lin_vel', ('world',)), ('base_lin_vel', ('base',)),
    ('base_ang_vel', ('world',)), ('base_ang_vel', ('base',)),
    ('target_base_vel', ('world',)), ('target_base_vel', ('base',)),
    ('base_lin_vel_err', ('world',)), ('base_lin_vel_err', ('base',)),
    ('base_ang_vel_err', ('world',)), ('base_ang_vel_err', ('base',)),
    ('base_lin_acc', ('world',)), ('base_lin_acc', ('base',)),
    ('feet_contact_state', ('world', False)), ('feet_contact_state', ('world', True)),
    ('feet_contact_state', ('base', True)), ('get_hyperparameters', ()),
]


@pytest.mark.parametrize('name,args', ACCESSORS, ids=lambda x: x if isinstance(x, str) else
                         '-'.join(map(str, x)) if x else 'property')
def test_accessor(envs, name, args):
    jenv, env = envs[:2]
    get = lambda e: getattr(e, name) if args is None else getattr(e, name)(*args)
    got, want = get(env), get(jenv)
    if name == 'get_hyperparameters':
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k != 'sim_dt'} == \
            {k: v for k, v in want.items() if k != 'sim_dt'}
        return
    if name.startswith('legs_') and name.endswith('_idx'):
        want = type(want)(*[np.asarray(x) for x in want])
    if name == 'feet_contact_state':
        assert any(got[0]), 'no foot touches: the contact accessors compare nothing'
    _same(got, want, name)


def test_forward_is_lazy(envs):
    """A step drops the Forward; the first accessor after it refreshes it."""
    env = envs[1]
    assert env._fwd is not None or env.fwd is not None
    fwd = env.fwd
    assert env.fwd is fwd


KEYS = (262, 263, 265, 264, 345, 32, 0)


@pytest.mark.parametrize('keycode', KEYS)
def test_key_callback(envs, keycode):
    jenv, env = envs[:2]
    js, ps = jenv._state, env._state
    try:
        for presses in (1, 40):    # once, then past the clips (6 hip heights, 2 pi)
            paused = env.is_paused, jenv.is_paused
            for _ in range(presses):
                jenv._key_callback(keycode)
                env._key_callback(keycode)
            _same(env._state.ref_base_lin_vel_H[0].numpy(),
                  np.asarray(jenv._state.ref_base_lin_vel_H), f'key {keycode} lin')
            _same(env._state.ref_base_ang_yaw_dot[0].numpy(),
                  np.asarray(jenv._state.ref_base_ang_yaw_dot), f'key {keycode} yaw')
            assert env.is_paused == jenv.is_paused
            if keycode == 32:
                assert env.is_paused == (paused[0] != (presses % 2 == 1))
            assert env._state.ref_base_lin_vel_H.shape == (1, 3)
            assert env._state.ref_base_ang_yaw_dot.shape == (1,)
    finally:
        jenv._state, env._state = js, ps
        jenv.is_paused = env.is_paused = False


def test_spaces(envs):
    jenv, env = envs[:2]
    for attr in ('low', 'high', 'shape', 'dtype'):
        assert np.array_equal(getattr(env.action_space, attr), getattr(jenv.action_space, attr))
    assert list(env.observation_space) == list(jenv.observation_space)
    assert set(env.observation_space) == set(OBS)
    for name in OBS:
        got, want = env.observation_space[name], jenv.observation_space[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.low, want.low, err_msg=name)
        np.testing.assert_array_equal(got.high, want.high, err_msg=name)
    sample = env.action_space.sample()
    assert sample.shape == (12,) and env.action_space.contains(sample)


def test_seeded_random_reset_repeats(envs):
    env = envs[1]
    saved = env._state
    try:
        a = env.reset(seed=11)
        b = env.reset(seed=11)
        c = env.reset(seed=12)
        for name in OBS:
            assert np.array_equal(a[name], b[name]), name
            assert np.isfinite(a[name]).all(), name
        assert not np.array_equal(a['qpos'], c['qpos'])
    finally:
        env._state, env._fwd = saved, None


def test_render_raises_close_safe(envs, monkeypatch):
    jenv, env = envs[:2]
    monkeypatch.delenv('GYM_QUADRUPED_ASSETS', raising=False)
    raised = []
    for e in (env, jenv):
        e.close()                   # no viewer yet: nothing to close
        with pytest.raises(Exception) as info:
            e.render()
        raised.append(info.type)
        assert not hasattr(e, '_vis')
        e.close()
    assert raised == [FileNotFoundError] * 2
    with pytest.raises(ImportError, match='morpho_symm'):
        env.obs_group_reps
    with pytest.raises(ImportError, match='morpho_symm'):
        jenv.obs_group_reps
