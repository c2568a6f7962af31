"""The port's physics step on go2/flat against the JAX package's per-env
`engine.step`, in f64.

go2/flat has 1,180 contact slots, all elliptic cone slots (condim 3 and 6),
culled to the 32 nearest before assembly.

* Culling: at the keyframe lowered 2 cm into the floor, the left-right
  symmetric robot has equal distances across the 32nd place, so the culled
  set depends on the tie rule. The port keeps the lower slot first, as
  `jax.lax.top_k` does: the same slots (`cone_sel`) as the reference, and
  every row of `make_efc` within 1e-9.
* One `step_batched` against the reference's per-env `step`: 1e-9.
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
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import constraints as pcon
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
def go2():
    jm = jload('go2', 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name)
                                for f in dataclasses.fields(jm)}), 'cpu', torch.float64)
    # the reference's per-env step, compiled once for the module
    jstep = fast_jit(lambda q, v, c, w: jeng.step(jm, q, v, c, warmstart=w))
    return jm, dm, jstep


def test_cull_ties_match_top_k(go2):
    jm, dm, jstep = go2
    qpos = np.asarray(jm.key_qpos[0]).copy()
    qpos[2] -= 0.02
    zeros = np.zeros(jm.nv)
    _, _, rfwd = jstep(qpos, zeros, np.zeros(jm.nu), zeros)
    fwd = peng.forward(dm, torch.as_tensor(qpos[None]), torch.zeros(1, jm.nv, dtype=torch.float64),
                       torch.zeros(1, jm.nu, dtype=torch.float64))
    # a tie across the 32nd place: more slots at the 32nd distance than places left
    lay = pcon.constraint_layout(dm.m)
    dist = fwd.contacts.dist[0, torch.as_tensor(lay.cone_slots)].numpy()
    assert len(dist) == 1180
    kth = np.sort(dist)[peng.MAX_CONE_CONTACTS - 1]
    tied, below = int((dist == kth).sum()), int((dist < kth).sum())
    assert below < peng.MAX_CONE_CONTACTS < below + tied, (below, tied)
    np.testing.assert_array_equal(fwd.efc.cone_sel[0].numpy(), np.asarray(rfwd.efc.cone_sel))
    for f in dataclasses.fields(pcon.Efc):
        if getattr(rfwd.efc, f.name) is None:   # pyr_sel: no pyramidal rows
            assert getattr(fwd.efc, f.name) is None, f.name
            continue
        got, ref = getattr(fwd.efc, f.name)[0].numpy(), np.asarray(getattr(rfwd.efc, f.name))
        if ref.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, ref, err_msg=f.name)
        else:
            _close(got, ref, 1e-9, f.name)


def test_one_step_matches_per_env_step(go2):
    jm, dm, jstep = go2
    B = 3
    qpos, qvel, ctrl = _contact_state(jm, B, seed=21)
    warm = np.zeros((B, jm.nv))
    rq, rv, racc, rfc, rqc = _ref_steps(jstep, qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    efc = fwd.efc
    assert efc.J.shape[1:] == (24, 18) and efc.con_J.shape[1] == peng.MAX_CONE_CONTACTS
    # active blocks of both cone dimensions
    dims = efc.cone_dim_mask.sum(-1)[efc.con_active]
    assert bool((dims == 3).any()) and bool((dims == 6).any())
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, racc),
                           ('f_cone', fwd.f_cone, rfc),
                           ('qfrc_constraint', fwd.qfrc_constraint, rqc)]:
        _close(got, ref, 1e-9, name)


def test_trajectory_200_steps(go2):
    jm, dm, jstep = go2
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
