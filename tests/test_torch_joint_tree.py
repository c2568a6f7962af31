"""The port on a general joint tree against the JAX package, in f64.

The model is the port's fixture `models/fixtures/jointtree-flat.npz`
(scripts/torch_port/make_joint_tree.py): a free base, a ball-jointed tail
that rests on the floor, per leg two hinges on one body and a sprung, limited
slide joint; nq 23, nv 21. Both packages load the same archive. The
reference's physics runs as one vmapped program at B = 4 (its step at a
Newton cap of 30, and the kinematic quantities of its Forward), compiled at
`FAST_COMPILE`; its gym adapter's three programs (reset to a state, step,
Forward) are compiled the same way, side by side where the cores allow.

* At random states pressed into the floor: every `Kin` field, `cdof`,
  `cdof_dot`, `point_jacobian` and `point_jacobian_dot` of a foot and of
  the tail, the body velocities and accelerations (the IMU's inputs), M,
  qfrc_bias, qfrc_passive, the constraint rows, qacc and one step, to
  1e-9.
* The slide joints pushed past both ends of their range: the limit rows
  (`make_efc`) against the reference's, to 1e-9.
* A drop from 0.1 m onto the floor, 200 steps of seeded torques: qpos
  within 1e-3 at every step (the BASELINE bar).
* `QuadrupedEnv` at B = 4 against the reference env's single-env reset
  and step programs, and `QuadrupedGymEnv` against the reference adapter:
  a reset to a given state and 3 steps, states, observations, reward,
  flags to 1e-9; every adapter accessor to 1e-9. The random reset adds
  its joint noise to the tail's quaternion too (`qpos[7:]`, as the
  reference does), and `fk` normalises it.
* `Model.save` round trips through the port's `Model.load` and the
  reference's, on go2/flat and on the tree.
* Where `mujoco` imports: the archive the reference rebuilds from the MJCF
  equals the committed one array by array, and the port's qacc equals
  `mujoco.mj_forward`'s to 1e-8 at states in the air (the oracle's solver
  run to a tolerance of 1e-15).
"""

import dataclasses
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env import gym_adapter as jgym
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.models.model import Model as JModel
from gym_quadruped_tpu.physics import dynamics as jdyn
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.env.gym_adapter import QuadrupedGymEnv
from gym_quadruped_tpu_torch.env.state import state_from_numpy, tensor_fields
from gym_quadruped_tpu_torch.models.model import (
    BALL,
    COMPILED_DIR,
    JOINT_TREE,
    SLIDE,
    Model,
    to_device,
)
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import dynamics as pdyn
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_gym_adapter import ACCESSORS, _same
from test_torch_mixed import FAST_COMPILE
from test_torch_step import _close

TOL = 1e-9
B = 4
CAP = 30
DROP_STEPS = 200
KIN_FIELDS = [f.name for f in dataclasses.fields(pkin.Kin)]
EFC_ROWS = ('J', 'aref', 'R', 'active', 'frictionloss')
# 'qpos' and 'qpos_js' are left out: both packages' bounds of them take one
# qpos per joint past the free joint (`test_qpos_bounds_take_one_qpos_per_joint`)
OBS = ('qvel', 'base_pos', 'feet_pos:base', 'contact_state', 'base_lin_vel_err', 'work')
CONFIG = dict(robot='go2', scene='flat', state_obs_names=OBS, base_vel_command_type='forward',
              ref_base_lin_vel=0.4, ground_friction_coeff=0.8, solver_iterations=CAP)
N_ENV_STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU, and
    # without autograd's bookkeeping the 200-step drop takes ~2/3 of the time
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _points(m):
    """(name, geom id, body id) of the points whose Jacobians are held: the
    FL foot (hip, thigh and slide on its chain) and the tail (ball)."""
    return [(name, m.geom_names.index(name), int(m.geom_bodyid[m.geom_names.index(name)]))
            for name in ('FL', 'tail')]


def _reference_program(jm, points):
    """The reference's step at the Newton cap of CAP and the kinematic
    quantities of its Forward, vmapped over B and compiled at FAST_COMPILE."""
    def one(q, v, c, w):
        qn, vn, fwd = jeng.step(jm, q, v, c, warmstart=w, solver_iterations=CAP)
        kin, cdof = fwd.kin, fwd.cdof
        out = {'qpos_next': qn, 'qvel_next': vn, 'cdof': cdof,
               'body_velocities': jdyn.body_velocities(jm, kin, v, cdof),
               **{f'body_accelerations_{g}': jdyn.body_accelerations(
                   jm, kin, v, fwd.qacc, cdof, gravity_offset=g) for g in (True, False)},
               'cdof_dot': jkin.cdof_dot(jm, kin, v, cdof), 'M': fwd.M,
               'qfrc_bias': fwd.qfrc_bias, 'qfrc_passive': fwd.qfrc_passive,
               'qacc': fwd.qacc, **{f: getattr(kin, f) for f in KIN_FIELDS},
               **{f'efc_{k}': getattr(fwd.efc, k) for k in EFC_ROWS}}
        for name, g, b in points:
            p = kin.geom_xpos[g]
            out[f'jac_{name}'] = jkin.point_jacobian(jm, kin, cdof, p, b)
            out[f'jacdot_{name}'] = jkin.point_jacobian_dot(jm, kin, cdof, v, p, b)
        return out

    args = (jnp.zeros((B, jm.nq)), jnp.zeros((B, jm.nv)), jnp.zeros((B, jm.nu)),
            jnp.zeros((B, jm.nv)))
    return jax.jit(jax.vmap(one)).lower(*args)


def _fast_adapter(jenv):
    """The reference adapter's reset-to-state, step and Forward programs."""
    m = jenv.core.model
    key = jax.random.PRNGKey(0)
    qp, qv, ctrl = jnp.zeros(m.nq), jnp.zeros(m.nv), jnp.zeros(m.nu)
    reset = jenv._jit_reset_to.lower(key, qp, qv)
    return (reset, jenv._jit_step.lower(reset.out_info[0], ctrl),
            jenv._jit_forward.lower(qp, qv, ctrl))


@pytest.fixture(scope='module')
def tree():
    """(reference Model, port f64 model on the CPU, the reference's physics
    program, the reference adapter), every program compiled once."""
    jm = JModel.load(JOINT_TREE)
    dm = to_device(Model.load(JOINT_TREE), 'cpu', torch.float64)
    jenv = jgym.QuadrupedGymEnv(model=jm, **CONFIG)
    lowered = (_reference_program(jm, _points(jm)),) + _fast_adapter(jenv)
    with ThreadPoolExecutor(min(len(lowered), len(os.sched_getaffinity(0)))) as pool:
        ref, jenv._jit_reset_to, jenv._jit_step, jenv._jit_forward = pool.map(
            lambda p: p.compile(compiler_options=FAST_COMPILE), lowered)
    return jm, dm, ref, jenv


def _random_states(m, seed, air=False):
    """B states: joint offsets within the ranges, a random tail quaternion,
    random velocities and torques; pressed U(0, 1) cm into the floor, or
    with air, the base 0.5 m up."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, :2] = rng.uniform(-0.2, 0.2, (B, 2))
    qpos[:, 2] += 0.5 if air else -0.0054 - rng.uniform(0.0, 0.01, B)
    legs = np.asarray(m.legs_qpos_idx).reshape(-1)
    qpos[:, legs] += rng.uniform(-0.3, 0.3, (B, 12)) * np.tile([1.0, 1.0, 0.1], 4)
    tail = int(m.jnt_qposadr[np.flatnonzero(m.jnt_type == BALL)[0]])
    quat = rng.randn(B, 4)
    qpos[:, tail:tail + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = 0.5 * rng.randn(B, m.nv)
    ctrl = rng.uniform(-3, 3, (B, m.nu))
    return qpos, qvel, ctrl


def _both(tree, qpos, qvel, ctrl, warm=None):
    """(the reference program's outputs as numpy, the port's step_batched and
    its Forward) at the same states, at the Newton cap of CAP."""
    jm, dm, ref, _ = tree
    warm = np.zeros((B, jm.nv)) if warm is None else warm
    want = {k: np.asarray(v) for k, v in ref(qpos, qvel, ctrl, warm).items()}
    got = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                            solver_iterations=CAP)
    return want, got


def test_check_joints_takes_every_type(tree):
    _, dm, _, _ = tree
    m = dm.m
    assert sorted(set(m.jnt_type.tolist())) == [0, 1, 2, 3]
    assert int(m.body_jntnum.max()) == 2 and (m.nq, m.nv) == (23, 21)
    pkin.check_joints(m)
    with pytest.raises(NotImplementedError, match='unknown joint types'):
        pkin.check_joints(dataclasses.replace(m, jnt_type=np.where(m.jnt_type == 1, 4,
                                                                   m.jnt_type)))


@pytest.mark.parametrize('seed', [0, 1])
def test_smooth_and_step_match(tree, seed):
    jm, dm, _, _ = tree
    qpos, qvel, ctrl = _random_states(jm, seed)
    want, (q, v, fwd) = _both(tree, qpos, qvel, ctrl)
    assert bool(fwd.efc.con_active.any()), 'no contact: the contact rows compare nothing'
    for f in KIN_FIELDS:
        _close(getattr(fwd.kin, f), want[f], TOL, f'kin.{f}')
    vel = torch.as_tensor(qvel)
    got = {'cdof': fwd.cdof, 'cdof_dot': pkin.cdof_dot(dm, fwd.kin, vel, fwd.cdof),
           'body_velocities': pdyn.body_velocities(dm, fwd.kin, vel, fwd.cdof),
           **{f'body_accelerations_{g}': pdyn.body_accelerations(
               dm, fwd.kin, vel, fwd.qacc, fwd.cdof, gravity_offset=g) for g in (True, False)},
           'M': fwd.M, 'qfrc_bias': fwd.qfrc_bias, 'qfrc_passive': fwd.qfrc_passive,
           'qacc': fwd.qacc, 'qpos_next': q, 'qvel_next': v,
           **{f'efc_{k}': getattr(fwd.efc, k) for k in EFC_ROWS}}
    for name, g, b in _points(jm):
        p = fwd.kin.geom_xpos[:, g]
        got[f'jac_{name}'] = pkin.point_jacobian(dm, fwd.kin, fwd.cdof, p, b)
        got[f'jacdot_{name}'] = pkin.point_jacobian_dot(dm, fwd.kin, fwd.cdof, vel, p, b)
    for k, x in got.items():
        if x.dtype == torch.bool:
            np.testing.assert_array_equal(x.numpy(), want[k], err_msg=k)
        else:
            _close(x, want[k], TOL, k)
    # the ball's three dofs and both hinges of a body reach the point
    # Jacobians: the tail's through the ball, the foot's through all three legs
    # joints and the base
    tail_dofs = np.flatnonzero(np.abs(got['jac_tail'].numpy()).sum((0, 1)) > 0)
    ball = int(jm.jnt_dofadr[np.flatnonzero(jm.jnt_type == BALL)[0]])
    assert set(range(ball, ball + 3)) <= set(tail_dofs.tolist())
    foot_dofs = np.flatnonzero(np.abs(got['jac_FL'].numpy()).sum((0, 1)) > 0).tolist()
    assert foot_dofs == list(range(6)) + np.asarray(jm.legs_qvel_idx[0]).tolist()


def test_slide_limit_rows(tree):
    """Every slide past an end of its range: its limit row is active, and the
    rows, the solve and the step match the reference's."""
    jm, dm, _, _ = tree
    qpos, qvel, ctrl = _random_states(jm, 5)
    slides = np.flatnonzero(jm.jnt_type == SLIDE)
    over = np.where(np.arange(B)[:, None] % 2 == 0, jm.jnt_range[slides, 1] + 0.01,
                    jm.jnt_range[slides, 0] - 0.01)
    qpos[:, jm.jnt_qposadr[slides]] = over
    want, (q, v, fwd) = _both(tree, qpos, qvel, ctrl)
    lay = pcon.constraint_layout(dm.m)
    rows = lay.n_fl + np.flatnonzero(np.isin(lay.lim_jnts, slides))
    assert len(rows) == 4 and bool(fwd.efc.active[:, rows].all())
    sign = fwd.efc.J[:, rows][..., jm.jnt_dofadr[slides]].diagonal(0, 1, 2)
    np.testing.assert_array_equal(sign.numpy(), np.where(np.arange(B)[:, None] % 2 == 0,
                                                          -1.0, 1.0) * np.ones((B, 4)))
    for k in EFC_ROWS:
        x = getattr(fwd.efc, k)
        if x.dtype == torch.bool:
            np.testing.assert_array_equal(x.numpy(), want[f'efc_{k}'], err_msg=k)
        else:
            _close(x, want[f'efc_{k}'], TOL, f'efc.{k}')
    for name, x in (('qacc', fwd.qacc), ('qpos_next', q), ('qvel_next', v)):
        _close(x, want[name], TOL, name)


def test_drop_200_steps(tree):
    """Dropped from 0.1 m above the keyframe, seeded U(-2, 2) torques, the
    qacc warm start threaded: qpos within 1e-3 at every step, and the feet
    and the tail land."""
    jm, dm, ref, _ = tree
    rng = np.random.RandomState(7)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 2] += 0.1
    legs = np.asarray(jm.legs_qpos_idx).reshape(-1)
    qpos[:, legs] += rng.uniform(-0.1, 0.1, (B, 12)) * np.tile([1.0, 1.0, 0.1], 4)
    qvel, warm = np.zeros((B, jm.nv)), np.zeros((B, jm.nv))
    q, v, w = (torch.as_tensor(x) for x in (qpos, qvel, warm))
    lay = pcon.constraint_layout(dm.m)
    worst, touched = 0.0, np.zeros(len(lay.con_geom2), bool)
    for t in range(DROP_STEPS):
        ctrl = rng.uniform(-2, 2, (B, jm.nu))
        out = ref(qpos, qvel, ctrl, warm)
        qpos, qvel, warm = (np.asarray(out[k]) for k in ('qpos_next', 'qvel_next', 'qacc'))
        q, v, fwd = peng.step_batched(dm, q, v, torch.as_tensor(ctrl), warmstart=w,
                                      solver_iterations=CAP)
        w = fwd.qacc
        touched |= (fwd.contacts.dist < 0).any(0).numpy()
        worst = max(worst, float(np.abs(q.numpy() - qpos).max()))
    assert worst < 1e-3, worst
    landed = {jm.geom_names[g] for g in np.asarray(lay.con_geom2)[touched]}
    assert landed == {'FL', 'FR', 'RL', 'RR', 'tail'}, landed
    assert np.isfinite(q.numpy()).all()


def _reset_ref(jenv, qpos, qvel):
    """The reference env's reset to each given state, stacked over envs."""
    outs = [jenv._jit_reset_to(jax.random.PRNGKey(i), jnp.asarray(q), jnp.asarray(v))
            for i, (q, v) in enumerate(zip(qpos, qvel))]
    stack = lambda *xs: np.stack([np.asarray(x) for x in xs])
    return jax.tree.map(stack, *[o[0] for o in outs]), jax.tree.map(stack, *[o[1] for o in outs])


def _check_state(state, ref, where):
    for f in tensor_fields(type(state)):
        got, want = getattr(state, f.name).numpy(), np.asarray(getattr(ref, f.name))
        if want.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, want, err_msg=f'{where} {f.name}')
        else:
            _close(got, want, TOL, f'{where} {f.name}')


@pytest.fixture(scope='module')
def env_runs(tree):
    """QuadrupedEnv at B = 4 and the reference env (its single-env programs,
    env by env): a reset to given states, then N_ENV_STEPS steps of seeded
    torques from the reference's reset state carried over."""
    jm, dm, _, jenv = tree
    env = QuadrupedEnv(model=dm, **CONFIG)
    rng = np.random.RandomState(9)
    qpos, qvel, _ = _random_states(jm, 9)
    qpos[:, 2] += 0.004
    qvel *= 0.2
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, B, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
    jstate, jobs = _reset_ref(jenv, qpos, qvel)
    runs = [('reset', state, obs, jstate, jobs, None)]
    state = state_from_numpy(jstate, 'cpu', torch.float64)
    for t in range(N_ENV_STEPS):
        a = rng.uniform(-2, 2, (B, jm.nu))
        state, obs, reward, term, trunc, info = env.step(state, torch.as_tensor(a))
        outs = [jenv._jit_step(jax.tree.map(lambda x, i=i: x[i], jstate), jnp.asarray(a[i]))
                for i in range(B)]
        stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)
        jstate = stacked[0]
        runs.append((f'step {t}', state, obs, jstate, stacked[1],
                     ((reward, term, trunc), stacked[2:5])))
    return runs


@pytest.mark.parametrize('i', range(N_ENV_STEPS + 1))
def test_env_matches_reference(env_runs, i):
    where, state, obs, jstate, jobs, flags = env_runs[i]
    _check_state(state, jstate, where)
    assert set(obs) == set(OBS)
    for name in OBS:
        _close(obs[name], np.asarray(jobs[name]), TOL, f'{where} obs {name}')
    if flags is not None:
        for got, want, name in zip(flags[0], flags[1], ('reward', 'terminated', 'truncated')):
            _close(got.double(), np.asarray(want, np.float64), TOL, f'{where} {name}')


def test_random_reset_perturbs_the_tail_quaternion(tree):
    """The random pose adds the joint noise to every qpos past the base, the
    tail's quaternion among them (the reference's `qpos[7:]`), so that
    quaternion is no longer of unit norm; `fk` normalises it, and the reset's
    step integrates it back onto the unit sphere."""
    jm, dm, _, _ = tree
    env = QuadrupedEnv(model=dm, **CONFIG)
    tail = int(jm.jnt_qposadr[np.flatnonzero(jm.jnt_type == BALL)[0]])
    qpos, _ = env._randomize_qpos(torch.Generator().manual_seed(3), 16, None)
    noise = qpos[:, 7:] - torch.as_tensor(jm.key_qpos[0][7:])
    assert float(noise.abs().max()) <= 20 * np.pi / 180
    norms = qpos[:, tail:tail + 4].norm(dim=1)
    assert float((norms - 1).abs().min()) > 1e-3
    unit = qpos.clone()
    unit[:, tail:tail + 4] /= norms[:, None]
    _close(pkin.fk(dm, qpos).xquat, pkin.fk(dm, unit).xquat.numpy(), 1e-12, 'xquat')
    state, _ = env.reset(torch.Generator().manual_seed(3), 16)
    _close(state.qpos[:, tail:tail + 4].norm(dim=1), np.ones(16), 1e-12, 'norm after the reset')
    state = env.step(state, torch.zeros(16, jm.nu))[0]
    assert bool(torch.isfinite(state.qpos).all())


@pytest.fixture(scope='module')
def adapters(tree):
    """The reference adapter and the port's at B = 1, reset to the same state
    and stepped N_ENV_STEPS times with the same torques."""
    jm, dm, _, jenv = tree
    env = QuadrupedGymEnv(model=dm, **CONFIG)
    qpos, qvel, _ = _random_states(jm, 11)
    qpos[:, 2] += 0.004
    obs = (jenv.reset(qpos=qpos[0], qvel=0.2 * qvel[0], random=False, seed=1),
           env.reset(qpos=qpos[0], qvel=0.2 * qvel[0], random=False, seed=1))
    env._state = state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], jenv._state),
                                  'cpu', torch.float64)
    rng = np.random.RandomState(12)
    steps = []
    for _ in range(N_ENV_STEPS):
        a = rng.uniform(-2, 2, jm.nu)
        steps.append((jenv.step(a), env.step(a)))
    return jenv, env, obs, steps


def test_adapter_reset_and_steps(adapters):
    _, _, (want, got), steps = adapters
    _same(got, {k: np.asarray(v) for k, v in want.items()}, 'reset obs')
    for t, (want, got) in enumerate(steps):
        _same(got, want, f'step {t}')


@pytest.mark.parametrize('name,args', [a for a in ACCESSORS if a[0] != 'get_hyperparameters'],
                         ids=lambda x: x if isinstance(x, str) else
                         '-'.join(map(str, x)) if x else 'property')
def test_adapter_accessor(adapters, name, args):
    jenv, env = adapters[:2]
    get = lambda e: getattr(e, name) if args is None else getattr(e, name)(*args)
    got, want = get(env), get(jenv)
    if name.startswith('legs_') and name.endswith('_idx'):
        want = type(want)(*[np.asarray(x) for x in want])
    _same(got, want, name)


@pytest.mark.parametrize('archive', ['go2-flat', 'jointtree-flat'])
def test_model_save_round_trip(tmp_path, archive):
    """`Model.save` writes the reference's format: the port's `Model.load` and
    the reference's read back every field of the model saved."""
    path = JOINT_TREE if archive == 'jointtree-flat' else COMPILED_DIR / f'{archive}.npz'
    m = Model.load(path)
    out = tmp_path / f'{archive}.npz'
    m.save(out)
    for again in (Model.load(out), JModel.load(out)):
        for f in dataclasses.fields(Model):
            got, want = getattr(again, f.name), getattr(m, f.name)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype and np.array_equal(got, want), f.name
            else:
                assert got == want and type(got) is type(want), f.name
    if archive == 'go2-flat':
        jm = jload('go2', 'flat')
        assert all(np.array_equal(getattr(JModel.load(out), f.name), getattr(jm, f.name))
                   for f in dataclasses.fields(JModel))


@pytest.mark.parametrize('name', ['qpos', 'qpos_js'])
def test_qpos_bounds_take_one_qpos_per_joint(name):
    """The joint-range bounds of qpos and qpos_js read jnt_range[1:], one qpos
    per joint past the free joint; on the tree (a ball's 4 qpos) both
    packages refuse them alike, and the observables themselves are held by
    the env's state."""
    from gym_quadruped_tpu.env import observables as jobs
    from gym_quadruped_tpu_torch.env import observables as pobs

    for mod, m in ((jobs, JModel.load(JOINT_TREE)), (pobs, Model.load(JOINT_TREE))):
        with pytest.raises(ValueError, match='could not broadcast'):
            mod.obs_limits(m, name)


def _make_joint_tree():
    """scripts/torch_port/make_joint_tree.py as a module."""
    path = Path(__file__).resolve().parents[1] / 'scripts' / 'torch_port' / 'make_joint_tree.py'
    spec = importlib.util.spec_from_file_location('make_joint_tree', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_archive_rebuilds_from_the_mjcf():
    """The reference's `extract_model` on the tree's MJCF gives the archive
    that the port's builder wrote (tests/test_torch_builder.py holds the
    port's `models.builder` to the same archive)."""
    pytest.importorskip('mujoco')
    from gym_quadruped_tpu.models.builder import extract_model

    mk = _make_joint_tree()
    rebuilt = extract_model(mk.mj_model(), mk.ROBOT, mk.SCENE, mk.TERRAIN_LIMITS)
    committed = JModel.load(JOINT_TREE)
    for f in dataclasses.fields(JModel):
        got, want = getattr(rebuilt, f.name), getattr(committed, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), f.name
        else:
            assert got == want, f.name


def test_qacc_matches_mujoco():
    mujoco = pytest.importorskip('mujoco')
    mjm = _make_joint_tree().mj_model()
    mjm.opt.tolerance, mjm.opt.iterations = 1e-15, 1000
    dm = to_device(Model.load(JOINT_TREE), 'cpu', torch.float64)
    qpos, qvel, ctrl = _random_states(dm.m, 13, air=True)
    slide = int(dm.m.jnt_qposadr[np.flatnonzero(dm.m.jnt_type == SLIDE)[0]])
    qpos[0, slide] = dm.m.jnt_range[np.flatnonzero(dm.m.jnt_type == SLIDE)[0], 1] + 0.01
    fwd = peng.forward(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl)),
                       solver_iterations=100)
    assert bool(fwd.efc.active[0].any())
    d = mujoco.MjData(mjm)
    for b in range(B):
        d.qpos[:], d.qvel[:], d.ctrl[:] = qpos[b], qvel[b], ctrl[b]
        mujoco.mj_forward(mjm, d)
        assert d.ncon == 0
        _close(fwd.qacc[b], d.qacc.copy(), 1e-8, f'qacc against mj_forward, env {b}')


def test_jacobians_against_mujoco():
    """`point_jacobian` equals `mujoco.mj_jac` on every column, and
    `point_jacobian_dot` equals `mj_jacDot` on every column but those of a
    body's earlier joints: like the reference's `cdof_dot`, the port crosses
    each axis with its body's whole velocity, where MuJoCo takes the velocity
    of the joint's own frame, which leaves out the body's later joints (on
    the tree: the hip hinge, under the thigh hinge of its body)."""
    mujoco = pytest.importorskip('mujoco')
    mjm = _make_joint_tree().mj_model()
    dm = to_device(Model.load(JOINT_TREE), 'cpu', torch.float64)
    m = dm.m
    qpos, qvel, _ = _random_states(m, 17, air=True)
    kin = pkin.fk(dm, torch.as_tensor(qpos))
    cdof = pkin.cdof(dm, kin)
    earlier = [int(m.jnt_dofadr[j]) for b in range(1, m.nbody)
               for j in range(int(m.body_jntadr[b]), int(m.body_jntadr[b] + m.body_jntnum[b]) - 1)]
    assert len(earlier) == 4
    later = np.setdiff1d(np.arange(m.nv), earlier)
    d = mujoco.MjData(mjm)
    for b in range(B):
        d.qpos[:], d.qvel[:] = qpos[b], qvel[b]
        mujoco.mj_forward(mjm, d)
        for name in ('FL', 'tail'):
            g = m.geom_names.index(name)
            body = int(m.geom_bodyid[g])
            jac, jacdot = np.zeros((3, m.nv)), np.zeros((3, m.nv))
            mujoco.mj_jac(mjm, d, jac, None, d.geom_xpos[g], body)
            mujoco.mj_jacDot(mjm, d, jacdot, None, d.geom_xpos[g], body)
            p = kin.geom_xpos[:, g]
            got = pkin.point_jacobian(dm, kin, cdof, p, body)[b]
            _close(got, jac, 1e-12, f'{name} point_jacobian, env {b}')
            got = pkin.point_jacobian_dot(dm, kin, cdof, torch.as_tensor(qvel), p, body)[b]
            _close(got[:, later], jacdot[:, later], 1e-12, f'{name} point_jacobian_dot, env {b}')
