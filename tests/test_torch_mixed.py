"""The port's MixedQuadrupedEnv: against the port's homogeneous envs, and
against the JAX package's MixedQuadrupedEnv, in f64 on the CPU.

* go2 2 + mini_cheetah 2 (no JAX): the mixed reset draws the groups from
  one generator in group order, and 3 mixed steps equal each group's own
  homogeneous env exactly (atol 0): states, observations, reward,
  terminations, info. A HeightMap of another size on each group (3 x 3 on
  go2, 4 x 5 on mini_cheetah) exercises the padding and the zero fill: all
  compiled robots share nq 19, nv 18 and nu 12, so qpos, qvel and actions
  are never padded.
* go2 2 + aliengo 2 against the reference, both with their contact pairs
  cut to the feet's on both sides (as tests/test_torch_env_sensors.py does,
  so that the reference compiles no full-pair robot program) and a
  HeightMap on aliengo alone: from the reference's random reset, carried
  over with `state_from_numpy`, 5 steps at a Newton cap of 30; states,
  padded observations, masks, robot_ids, reward, terminations and info at
  1e-9. The reference's two programs compile at XLA's lowest optimisation
  level: it changes how long they take to build, not what they compute
  beyond rounding.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.env.mixed import MixedQuadrupedEnv as JMixed
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.env import MixedQuadrupedEnv, QuadrupedEnv
from gym_quadruped_tpu_torch.env.state import state_from_numpy, tensor_fields
from gym_quadruped_tpu_torch.models.model import from_arrays, load_model, to_device
from test_torch_step import _close

OBS = ('qpos', 'qvel', 'contact_state')
HM = ('qpos', 'qvel', 'contact_state', 'height_map_z')
# XLA's lowest optimisation level for the reference's programs: ~half the
# compile time of the default on this CPU; without the fusion emitters the
# CPU backend compiles go2's step ~3x faster again (14.6 -> 5.3 s on one
# core) and runs it no slower, to 2e-14 of the same outputs
FAST_COMPILE = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True,
                'xla_cpu_use_fusion_emitters': False}


def fast_jit(fn):
    """`jax.jit(fn)` whose programs compile at FAST_COMPILE: one program per
    structure, shape and dtype of the arguments, as jit keeps them."""
    jitted = jax.jit(fn)
    programs = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), jnp.result_type(x)) for x in leaves))
        if key not in programs:
            programs[key] = jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return programs[key](*args)

    return call


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(robot):
    return load_model(robot, 'flat', device='cpu', dtype=torch.float64)


def _groups():
    """(robot, count, extra) of the port-only batch: per-group heightmaps of
    9 and 20 rays."""
    return [('go2', 2, {'model': _f64('go2'), 'state_obs_names': HM, 'sensors': (psen.HeightMap,),
                        'sensors_kwargs': ({'num_rows': 3, 'num_cols': 3},)}),
            ('mini_cheetah', 2, {'model': _f64('mini_cheetah'), 'state_obs_names': HM,
                                 'sensors': (psen.HeightMap,),
                                 'sensors_kwargs': ({'num_rows': 4, 'num_cols': 5},)})]


def _equal_states(got, want, where):
    for f in tensor_fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f'{where} {f.name}'
    for gs, ws in zip(got.sensors, want.sensors, strict=True):
        for f in dataclasses.fields(ws):
            assert torch.equal(getattr(gs, f.name), getattr(ws, f.name)), \
                f'{where} {type(ws).__name__}.{f.name}'


def test_mixed_matches_homogeneous():
    kw = dict(scene='flat', ground_friction_coeff=(0.5, 1.5), solver_iterations=30)
    mixed = MixedQuadrupedEnv(_groups(), state_obs_names=OBS, **kw)
    homog = [QuadrupedEnv(robot, **{**kw, **extra}) for robot, _, extra in _groups()]
    assert mixed.batch_size == 4 and (mixed.nq_max, mixed.nv_max, mixed.nu_max) == (19, 18, 12)
    assert mixed.obs_names == HM and mixed.robot_ids.tolist() == [0, 0, 1, 1]
    masks = mixed.obs_masks()
    assert masks['height_map_z'].shape == (4, 20)
    assert masks['height_map_z'].sum(1).tolist() == [9, 9, 20, 20]
    assert bool((masks['qpos'] == 1).all()) and bool((mixed.action_masks() == 1).all())

    state, obs = mixed.reset(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    starts = [env.reset(gen, 2) for env in homog]
    for g, (s, o) in enumerate(starts):
        _equal_states(state[g], s, f'reset group {g}')
    assert torch.equal(obs['height_map_z'][:2, 9:], torch.zeros(2, 11, dtype=torch.float64))

    actions = torch.rand(3, 4, 12, generator=torch.Generator().manual_seed(4),
                         dtype=torch.float64) * 4 - 2
    states = [s for s, _ in starts]
    for t in range(3):
        state, obs, reward, term, trunc, info = mixed.step(state, actions[t])
        for g, (env, rows) in enumerate(zip(homog, (slice(0, 2), slice(2, 4)))):
            states[g], o, r, te, tr, inf = env.step(states[g], actions[t, rows])
            _equal_states(state[g], states[g], f'step {t} group {g}')
            for name, v in o.items():
                assert torch.equal(obs[name][rows, :v.shape[1]], v), f'step {t} {name}'
                assert not bool(obs[name][rows, v.shape[1]:].any()), f'step {t} {name} pad'
            assert torch.equal(reward[rows], r) and torch.equal(term[rows], te)
            assert torch.equal(trunc[rows], tr)
            for k, v in inf.items():
                assert torch.equal(info[k][rows], v), f'step {t} info {k}'
    assert torch.equal(mixed.padded_qpos(state), torch.cat([s.qpos for s in states]))
    assert torch.equal(mixed.padded_qvel(state), torch.cat([s.qvel for s in states]))


def test_mixed_rejects_mixed_devices_and_empty():
    with pytest.raises(ValueError, match='at least one group'):
        MixedQuadrupedEnv([])
    with pytest.raises(ValueError, match='one device in one dtype'):
        MixedQuadrupedEnv([('go2', 1, {'model': _f64('go2')}),
                           ('aliengo', 1, {'model': load_model('aliengo', 'flat', device='cpu')})])


def _feet_only(robot):
    """The reference's model with its contact pairs cut to the feet's, and
    the port's model of the same arrays."""
    jm = jload(robot, 'flat')
    feet = set(np.asarray(jm.feet_geom_id).tolist())
    jm = dataclasses.replace(jm, contact_pairs=np.array(
        [p for p in np.asarray(jm.contact_pairs) if int(p[1]) in feet]))
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    return jm, dm


def test_mixed_matches_reference():
    (jgo2, go2), (jali, ali) = _feet_only('go2'), _feet_only('aliengo')
    kw = dict(scene='flat', state_obs_names=OBS, solver_iterations=30,
              ground_friction_coeff=(0.5, 1.5))
    jenv = JMixed([('go2', 2, {'model': jgo2}),
                   ('aliengo', 2, {'model': jali, 'sensors': (jsen.HeightMap,),
                                   'state_obs_names': HM})], **kw)
    env = MixedQuadrupedEnv([('go2', 2, {'model': go2}),
                             ('aliengo', 2, {'model': ali, 'sensors': (psen.HeightMap,),
                                             'state_obs_names': HM})], **kw)
    assert env.obs_names == jenv.obs_names and env.batch_size == jenv.batch_size
    np.testing.assert_array_equal(env.robot_ids.numpy(), np.asarray(jenv.robot_ids))
    for name, mask in jenv.obs_masks().items():
        np.testing.assert_array_equal(env.obs_masks()[name].numpy(), np.asarray(mask), name)
    np.testing.assert_array_equal(env.action_masks().numpy(), np.asarray(jenv.action_masks()))

    # the reference's reset and step programs, built side by side
    key = jax.random.PRNGKey(5)
    reset = jax.jit(jenv.reset).lower(key)
    step = jax.jit(jenv.step).lower(reset.out_info[0], jax.ShapeDtypeStruct((4, 12), jnp.float64))
    with ThreadPoolExecutor(2) as pool:
        jreset, jstep = pool.map(lambda p: p.compile(compiler_options=FAST_COMPILE), (reset, step))
    ref_state, _ = jreset(key)
    state = tuple(state_from_numpy(jax.tree.map(np.asarray, s), 'cpu', torch.float64)
                  for s in ref_state)
    actions = np.random.RandomState(6).uniform(-2, 2, (5, 4, 12))
    for t in range(5):
        ref_state, ref_obs, ref_r, ref_te, ref_tr, ref_info = jstep(ref_state,
                                                                    jnp.asarray(actions[t]))
        state, obs, r, te, tr, info = env.step(state, torch.as_tensor(actions[t]))
        for g, (s, rs) in enumerate(zip(state, ref_state, strict=True)):
            for f in tensor_fields(s):
                _close(getattr(s, f.name).double(), np.asarray(getattr(rs, f.name), np.float64),
                       1e-9, f'step {t} group {g} {f.name}')
            for ss, rss in zip(s.sensors, rs.sensors, strict=True):
                _close(ss.points, np.asarray(rss.points), 1e-9, f'step {t} heightmap')
        assert set(obs) == set(ref_obs) == set(HM)
        for name in HM:
            _close(obs[name], np.asarray(ref_obs[name]), 1e-9, f'step {t} obs {name}')
        _close(r, np.asarray(ref_r), 1e-9, f'step {t} reward')
        np.testing.assert_array_equal(te.numpy(), np.asarray(ref_te))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(ref_tr))
        assert set(info) == set(ref_info)
        for k, v in info.items():
            _close(v.double(), np.asarray(ref_info[k], np.float64), 1e-9, f'step {t} info {k}')
    assert bool((obs['height_map_z'][:2] == 0).all())
    _close(env.padded_qpos(state), np.asarray(jenv.padded_qpos(ref_state)), 1e-9, 'padded qpos')
