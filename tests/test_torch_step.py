"""The port's Newton solve and batched physics step against the JAX package's,
on spot/flat in f64.

* `solve` against the reference `solve` on the same M, a_smooth and rows: 1e-9.
* One `step_batched` against the reference's per-env `engine.step`: 1e-9.
* B=8 against the reference's vmapped `engine.step_batched`, which takes the
  batch-trailing twins: 1e-6, since the vmapped and per-env reference
  programs already differ at ~1e-9 and the Newton solve amplifies it.
* 200 steps at B=4 from the keyframe with seeded U(-2, 2) torques and the
  qacc warm start threaded, against `engine.step`: within 1e-3 in qpos (the
  BASELINE bar).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu.physics import solver as jsol
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import solver as psol


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def spot():
    jm = jload('spot', 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name)
                                for f in dataclasses.fields(jm)}), 'cpu', torch.float64)
    # the reference's per-env step, compiled once for the module
    jstep = jax.jit(lambda q, v, c, w: jeng.step(jm, q, v, c, warmstart=w))
    return jm, dm, jstep


def _ref_steps(jstep, qpos, qvel, ctrl, warm):
    outs = [jstep(*x) for x in zip(qpos, qvel, ctrl, warm)]
    stack = lambda get: np.stack([np.asarray(get(o)) for o in outs])
    return (stack(lambda o: o[0]), stack(lambda o: o[1]), stack(lambda o: o[2].qacc),
            stack(lambda o: o[2].f_cone), stack(lambda o: o[2].qfrc_constraint))


def _close(got, ref, tol, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = 1 + np.abs(ref).max(initial=0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=name)


def _contact_state(jm, B, seed):
    """Keyframe pressed into the floor with joint offsets and velocities, and
    torques; env 0's torques exceed the control range."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.03, B)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, jm.nq - 7))
    qvel = 0.5 * rng.randn(B, jm.nv)
    ctrl = rng.uniform(-2, 2, (B, jm.nu))
    ctrl[0] = 2 * np.asarray(jm.actuator_ctrlrange[:, 1]) * np.sign(rng.randn(jm.nu))
    return qpos, qvel, ctrl


def test_solve_matches(spot):
    jm, dm, _ = spot
    B = 3
    qpos, qvel, ctrl = _contact_state(jm, B, seed=11)
    lay = jcon.constraint_layout(jm)

    pre = jax.jit(lambda q, v, c: jeng._pre_solve(jm, q, v, c,
                                                  max_cone=jeng.MAX_CONE_CONTACTS))
    ref_solve = jax.jit(lambda M, a, efc, w: jsol.solve(jm, lay, M, a, efc, warmstart=w))
    outs = [pre(q, v, c) for q, v, c in zip(qpos, qvel, ctrl)]
    st = lambda get: torch.as_tensor(np.stack([np.asarray(get(o)) for o in outs]))
    M, a_smooth = st(lambda o: o[2]), st(lambda o: o[7])
    efc = pcon.Efc(**{k.name: st(lambda o, k=k: getattr(o[9], k.name))
                      for k in dataclasses.fields(pcon.Efc)
                      if getattr(outs[0][9], k.name) is not None})
    assert bool(efc.con_active.any())
    warm = np.random.RandomState(12).randn(B, jm.nv)
    # no warm start means starting from a_smooth, on both sides
    for port_warm, ref_warm in ((None, a_smooth.numpy()), (torch.as_tensor(warm), warm)):
        ref = [ref_solve(o[2], o[7], o[9], w) for o, w in zip(outs, ref_warm)]
        got = psol.solve(M, a_smooth, efc, warmstart=port_warm)
        for i, name in enumerate(('qacc', 'f_simple', 'f_cone', 'qfrc')):
            _close(got[i], np.stack([np.asarray(r[i]) for r in ref]), 1e-9, name)


def test_one_step_matches_per_env_step(spot):
    jm, dm, jstep = spot
    B = 4
    qpos, qvel, ctrl = _contact_state(jm, B, seed=21)
    warm = np.zeros((B, jm.nv))
    rq, rv, racc, rfc, rqc = _ref_steps(jstep, qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    assert bool(fwd.efc.con_active.any())
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, racc),
                           ('f_cone', fwd.f_cone, rfc),
                           ('qfrc_constraint', fwd.qfrc_constraint, rqc)]:
        _close(got, ref, 1e-9, name)
    # one env through the single-env entry point
    q0, v0, _ = peng.step(dm, *(torch.as_tensor(x[1]) for x in (qpos, qvel, ctrl, warm)))
    _close(q0, rq[1], 1e-9, 'step qpos')
    _close(v0, rv[1], 1e-9, 'step qvel')


def test_batch_matches_vmapped_step_batched(spot):
    jm, dm, _ = spot
    B = 8
    qpos, qvel, ctrl = _contact_state(jm, B, seed=31)
    warm = np.zeros((B, jm.nv))
    rq, rv, rfwd = jax.jit(lambda q, v, c, w: jeng.step_batched(jm, q, v, c, warmstart=w))(
        qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, rfwd.qacc),
                           ('f_cone', fwd.f_cone, rfwd.f_cone)]:
        _close(got, np.asarray(ref), 1e-6, name)


def test_trajectory_200_steps(spot):
    jm, dm, jstep = spot
    B, T = 4, 200
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
        n_active += int(fwd.efc.con_active.sum())
    assert n_active > 0, 'the trajectory never reached the contact path'
    assert np.isfinite(q.numpy()).all()
    err = np.abs(q.numpy() - rq).max()
    assert err < 1e-3, err
