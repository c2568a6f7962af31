"""The port's physics step on aliengo/flat, the pyramidal-cone slice's main
path, against the JAX package's per-env `engine.step`, in f64.

aliengo/flat: ns 148 (12 friction-loss rows, 8 limit rows and 32 culled
slots x 4 pyramidal rows), no cone blocks (C = 0).

* One `step_batched` against `engine.step` on 3 contact states (the
  keyframe pressed up to 3 cm into the floor, joints +-0.1 rad off, random
  qvel and torques): 1e-9.
* 200 steps at B=2 from the keyframe with seeded U(-2, 2) torques and the
  qacc warm start threaded: within 1e-3 in qpos (the BASELINE bar).
* The port's `QuadrupedEnv` on aliengo/flat: 20 `env.step` from the feet
  on the floor against the same per-env step, within 1e-3 in qpos. With
  the env's default friction (the ground's and the feet's sliding
  friction 1, the model's own) its per-env friction table gives the
  pyramidal rows the model's mu, so the reference's env step is this
  `engine.step` and the module's one program serves both.

b2/flat and hyqreal2/flat take one step each in test_torch_step_b2.py and
test_torch_step_hyqreal2.py, and aliengo's batch against the reference's
`step_batched` is in test_torch_batched_pyramidal.py: each file compiles
one reference program, ~1.5 min of XLA on one CPU core, so that the test
runner can spread them over its workers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.env import QuadrupedEnv, init_state
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import engine as peng
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state, _ref_steps


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def robot_of():
    """robot -> (jm, dm, the reference's jitted per-env step), made once."""
    made = {}

    def get(robot):
        if robot not in made:
            jm = jload(robot, 'flat')
            dm = to_device(from_arrays({f.name: getattr(jm, f.name)
                                        for f in dataclasses.fields(jm)}), 'cpu', torch.float64)
            made[robot] = jm, dm, fast_jit(lambda q, v, c, w: jeng.step(jm, q, v, c, warmstart=w))
        return made[robot]
    return get


def check_one_step(robot_of, robot, ns):
    """One step_batched of 3 contact states against the per-env step."""
    jm, dm, jstep = robot_of(robot)
    B = 3
    qpos, qvel, ctrl = _contact_state(jm, B, seed=21)
    warm = np.zeros((B, jm.nv))
    rq, rv, racc, _, rqc = _ref_steps(jstep, qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    efc = fwd.efc
    assert efc.J.shape[1:] == (ns, jm.nv) and efc.con_J.shape[1] == 0
    assert fwd.f_cone.shape == (B, 0, 6)
    assert bool(fwd.efc_force[:, ns - 128:].ne(0).any()), 'no pyramidal row carries a force'
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, racc),
                           ('qfrc_constraint', fwd.qfrc_constraint, rqc)]:
        _close(got, ref, 1e-9, name)


def test_one_step_matches_per_env_step(robot_of):
    check_one_step(robot_of, 'aliengo', 148)


def test_trajectory_200_steps(robot_of):
    jm, dm, jstep = robot_of('aliengo')
    B, T = 2, 200
    rng = np.random.RandomState(0)
    ctrls = rng.uniform(-2, 2, (T, B, jm.nu))
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qvel = np.zeros((B, jm.nv))
    warm = np.zeros((B, jm.nv))
    rq, rv, rw = qpos, qvel, warm
    q, v, w = (torch.as_tensor(x) for x in (qpos, qvel, warm))
    n_active = 0
    for t in range(T):
        rq, rv, rw, _, _ = _ref_steps(jstep, rq, rv, ctrls[t], rw)
        q, v, fwd = peng.step_batched(dm, q, v, torch.as_tensor(ctrls[t]), warmstart=w)
        w = fwd.qacc
        n_active += int(fwd.efc.active[:, 20:].sum())
    assert n_active > 0, 'the trajectory never reached the contact path'
    assert np.isfinite(q.numpy()).all()
    err = np.abs(q.numpy() - rq).max()
    assert err < 1e-3, err


def test_env_trajectory_20_steps(robot_of):
    jm, dm, jstep = robot_of('aliengo')
    env = QuadrupedEnv('aliengo', model=dm, state_obs_names=('qpos', 'contact_state'))
    B, T = 3, 20
    rng = np.random.RandomState(6)
    ctrls = rng.uniform(-2, 2, (T, B, jm.nu))
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 2] -= 0.0127 + rng.uniform(0.0, 0.005, B)      # the feet on the floor
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, jm.nq - 7))
    qvel = 0.1 * rng.randn(B, jm.nv)
    state = dataclasses.replace(init_state(dm, B), qpos=torch.as_tensor(qpos),
                                qvel=torch.as_tensor(qvel),
                                geom_friction=env._sample_friction(None, B))
    rq, rv, rw = qpos, qvel, np.zeros((B, jm.nv))
    touched = 0
    for t in range(T):
        rq, rv, rw, _, _ = _ref_steps(jstep, rq, rv, ctrls[t], rw)
        state, obs, *_ = env.step(state, torch.as_tensor(ctrls[t]))
        touched += int(obs['contact_state'].sum())
    assert touched > 0, 'no foot touched the floor'
    err = np.abs(state.qpos.numpy() - rq).max()
    assert err < 1e-3, err
