"""The physics pieces of the port's env layer against the JAX package's, in
f64: the applied force and per-env friction of the step, the point
Jacobians, and the contact forces of physics/forces.py.

* One `step_batched` with `qfrc_applied` and a per-env `con_mu` (spot/flat)
  against the reference's per-env `engine.step` with the same: 1e-9. Both
  run the Newton solve with a cap of 30 iterations, so that it converges
  (to 1e-10 of 1 + |qacc|): these pressed contact states need up to 10 and
  more, and a solve stopped at the cap ends up to ~1e-5 apart between two
  programs of the reference itself (rounding, amplified).
* `runtime_con_mu` and `make_efc(con_mu=)` with a different friction table
  per env, on elliptic cone blocks (spot) and pyramidal rows (aliengo),
  against the reference's per-env `runtime_con_mu` and `make_efc` (vmapped)
  and its batched `constraints_bt.make_efc_bt`, all fed the port's contact
  features: 1e-9, and the friction moves the rows.
* `_point_jacobians` at the feet against the reference's: 1e-9.
* Every function of forces.py against the reference's on the port's own
  Forward (spot's cone forces, aliengo's culled pyramidal decode), and the
  unculled per-slot decode on go1/flat's and mini_cheetah/flat's layouts
  (condim 1 and 3 slots) with seeded solver forces: 1e-9.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu.physics import forces as jfor
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu.physics.collision import Contacts as JContacts
from gym_quadruped_tpu.physics.constraints_bt import make_efc_bt
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import forces as pfor
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state

MAX_CONE = 32
ITERATIONS = 30


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def models():
    made = {}

    def get(robot):
        if robot not in made:
            jm = jload(robot, 'flat')
            made[robot] = jm, to_device(from_arrays({f.name: getattr(jm, f.name)
                                                     for f in dataclasses.fields(jm)}),
                                        'cpu', torch.float64)
        return made[robot]
    return get


def _friction(jm, B, seed):
    """(B, ngeom, 3) friction tables that differ per env in every column."""
    rng = np.random.RandomState(seed)
    base = np.asarray(jm.geom_friction)
    return base * rng.uniform(0.5, 1.5, (B,) + base.shape)


def _states(jm, B, seed):
    """Contact states: spot's keyframe presses into the floor; aliengo's
    stands 12.7 mm above it, so it is lowered that much more."""
    qpos, qvel, ctrl = _contact_state(jm, B, seed)
    if jm.robot == 'aliengo':
        qpos[:, 2] -= 0.0127
    return qpos, qvel, ctrl


def test_step_with_applied_force_and_friction(models):
    jm, dm = models('spot')
    B = 3
    qpos, qvel, ctrl = _states(jm, B, seed=71)
    rng = np.random.RandomState(72)
    qfrc = 5.0 * rng.randn(B, jm.nv)
    warm = rng.randn(B, jm.nv)
    fric = _friction(jm, B, seed=73)
    con_mu = pcon.runtime_con_mu(dm, torch.as_tensor(fric))
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                                  ITERATIONS, qfrc_applied=torch.as_tensor(qfrc), con_mu=con_mu)
    assert bool(fwd.efc.con_active.any())
    jstep = fast_jit(lambda q, v, c, f, w, g: jeng.step(
        jm, q, v, c, qfrc_applied=f, warmstart=w, solver_iterations=ITERATIONS,
        con_mu=jcon.runtime_con_mu(jm, g)))
    for b in range(B):
        rq, rv, rf = jstep(qpos[b], qvel[b], ctrl[b], qfrc[b], warm[b], fric[b])
        for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, rf.qacc),
                               ('qfrc_smooth', fwd.qfrc_smooth, rf.qfrc_smooth),
                               ('f_cone', fwd.f_cone, rf.f_cone),
                               ('cone_mu', fwd.efc.cone_mu, rf.efc.cone_mu)]:
            _close(got[b], np.asarray(ref), 1e-9, f'{name} env {b}')
    # one env through the single-env entry point
    q1, v1, _ = peng.step(dm, *(torch.as_tensor(x[1]) for x in (qpos, qvel, ctrl, warm)),
                          ITERATIONS, qfrc_applied=torch.as_tensor(qfrc[1]), con_mu=con_mu[1])
    _close(q1, q[1].numpy(), 1e-12, 'step qpos')
    # the applied force enters the smooth force as it is
    _, _, fwd0 = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                                   ITERATIONS, con_mu=con_mu)
    _close(fwd.qfrc_smooth - fwd0.qfrc_smooth, qfrc, 1e-12, 'qfrc_applied')


@pytest.mark.parametrize('robot', ['spot', 'aliengo'])
def test_per_env_friction_rows(models, robot):
    jm, dm = models(robot)
    B = 4
    qpos, qvel, _ = _states(jm, B, seed=81)
    fric = _friction(jm, B, seed=82)
    con_mu = pcon.runtime_con_mu(dm, torch.as_tensor(fric))
    ref_mu = np.stack([np.asarray(jcon.runtime_con_mu(jm, jnp.asarray(f))) for f in fric])
    _close(con_mu, ref_mu, 1e-12, 'runtime_con_mu')

    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin = pkin.fk(dm, q)
    con = pcol.collide(dm, kin)
    efc = pcon.make_efc(dm, kin, q, v, con, pkin.cdof(dm, kin), con_mu=con_mu,
                        max_cone=MAX_CONE)
    feat = con.feat.numpy()

    def one(q, v, f, mu):
        k = jkin.fk(jm, q)
        return jcon.make_efc(jm, k, q, v, JContacts(f), jkin.cdof(jm, k), con_mu=mu,
                             max_cone=MAX_CONE)

    def batched(q, v, f, mu):
        k = jax.vmap(lambda x: jkin.fk(jm, x))(q)
        cdof = jax.vmap(lambda x: jkin.cdof(jm, x))(k)
        return make_efc_bt(jm, jcon.constraint_layout(jm), jnp.transpose(f, (1, 2, 0)), q, v,
                           cdof, k.subtree_com[:, 0], con_mu=mu, max_cone=MAX_CONE)

    refs = {'make_efc': fast_jit(jax.vmap(one))(qpos, qvel, feat, ref_mu),
            'make_efc_bt': fast_jit(batched)(qpos, qvel, feat, ref_mu)}
    for where, ref in refs.items():
        for f in dataclasses.fields(pcon.Efc):
            got, want = getattr(efc, f.name), getattr(ref, f.name)
            if got is None:
                assert want is None, f'{where} {f.name}'
                continue
            got, want = got.numpy(), np.asarray(want)
            if want.dtype.kind in 'bi':
                np.testing.assert_array_equal(got, want, err_msg=f'{where} {f.name}')
            else:
                _close(got, want, 1e-9, f'{where} {f.name}')
    # the tables moved the rows: the model's friction gives others
    static = pcon.make_efc(dm, kin, q, v, con, pkin.cdof(dm, kin), max_cone=MAX_CONE)
    moved = static.cone_mu if robot == 'spot' else static.J
    assert not torch.allclose(moved, efc.cone_mu if robot == 'spot' else efc.J)
    assert bool(efc.con_active.any() or efc.active[:, 20:].any())


def test_point_jacobians(models):
    jm, dm = models('spot')
    qpos, _, _ = _states(jm, 2, seed=91)
    kin = pkin.fk(dm, torch.as_tensor(qpos))
    cdof = pkin.cdof(dm, kin)
    pos = kin.geom_xpos[:, dm.m.feet_geom_id]
    jacp, jacr = pcon._point_jacobians(dm, kin, cdof, pos, dm.m.feet_body_id)
    for b in range(2):
        k = jkin.fk(jm, jnp.asarray(qpos[b]))
        rp, rr = jcon._point_jacobians(jm, k, jkin.cdof(jm, k), jnp.asarray(pos[b].numpy()),
                                       jm.feet_body_id)
        _close(jacp[b], np.asarray(rp), 1e-9, 'jacp')
        _close(jacr[b], np.asarray(rr), 1e-9, 'jacr')


def _as_reference(fwd, b):
    """Env b of a port Forward, as the reference's forces functions read it."""
    pyr_sel = fwd.efc.pyr_sel
    return SimpleNamespace(
        qacc=jnp.asarray(fwd.qacc[b].numpy()), f_cone=jnp.asarray(fwd.f_cone[b].numpy()),
        efc_force=jnp.asarray(fwd.efc_force[b].numpy()),
        efc=SimpleNamespace(pyr_sel=None if pyr_sel is None
                            else jnp.asarray(pyr_sel[b].numpy().astype(np.int32))),
        contacts=JContacts(jnp.asarray(fwd.contacts.feat[b].numpy())))


def _check_forces(jm, dm, fwd):
    lay = jcon.constraint_layout(jm)
    np.testing.assert_array_equal(pfor.feet_slot_mask(dm.m), jfor.feet_slot_mask(jm))
    np.testing.assert_array_equal(pfor.simple_row_table(pcon.constraint_layout(dm.m)),
                                  jfor.simple_row_table(lay))
    got = {'slot_forces_world': pfor.slot_forces_world(dm, fwd),
           'active_slots': pfor.active_slots(dm, fwd),
           'feet_contact_state': pfor.feet_contact_state(dm, fwd),
           'feet_contact_forces': pfor.feet_contact_forces(dm, fwd),
           'invalid_contact': pfor.invalid_contact(dm, fwd)}
    for b in range(fwd.qacc.shape[0]):
        f = _as_reference(fwd, b)
        ref = {'slot_forces_world': jfor.slot_forces_world(jm, lay, f),
               'active_slots': jfor.active_slots(lay, f),
               'feet_contact_state': jfor.feet_contact_state(jm, lay, f),
               'feet_contact_forces': jfor.feet_contact_forces(jm, lay, f),
               'invalid_contact': jfor.invalid_contact(jm, lay, f)}
        for name, want in ref.items():
            want = np.asarray(want)
            if want.dtype == bool:
                np.testing.assert_array_equal(got[name][b].numpy(), want, err_msg=name)
            else:
                _close(got[name][b], want, 1e-9, name)
    return got


@pytest.mark.parametrize('robot', ['spot', 'aliengo'])
def test_forces_match_reference(models, robot):
    jm, dm = models(robot)
    qpos, qvel, ctrl = _states(jm, 3, seed=101)
    qpos[0, 2] -= 0.3     # env 0 sinks its body into the floor
    fwd = peng.forward(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl)))
    got = _check_forces(jm, dm, fwd)
    touch, fz = got['feet_contact_state'], got['feet_contact_forces'][..., 2]
    assert bool(touch.any(1).all()), 'an env has no foot on the floor'
    assert bool((fz[touch] >= 0).all() and (fz[~touch] == 0).all())   # the floor pushes up
    # spot's only world pairs are its feet; aliengo's body boxes touch in env 0
    assert got['invalid_contact'].tolist() == [robot == 'aliengo', False, False]


@pytest.mark.parametrize('robot,condims', [('go1', {1}), ('mini_cheetah', {1, 3})])
def test_forces_per_slot_decode(models, robot, condims):
    """The unculled simple slots, decoded slot by slot (`pyr_sel` None) from
    seeded solver forces: go1/flat's condim-1 slots beside its elliptic
    blocks, mini_cheetah/flat's pyramidal condim-1 and condim-3 slots."""
    jm, dm = models(robot)
    lay = pcon.constraint_layout(dm.m)
    assert set(lay.con_condim[lay.simple_con_slots].tolist()) == condims
    B, S = 2, len(lay.con_condim)
    rng = np.random.RandomState(111)
    n = rng.randn(B, S, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    feat = np.concatenate([rng.uniform(-0.01, 0.01, (B, 1, S)),
                           rng.randn(B, 3, S), n.transpose(0, 2, 1)], 1)
    t = torch.as_tensor
    fwd = SimpleNamespace(
        qacc=t(rng.randn(B, jm.nv)), f_cone=t(rng.randn(B, len(lay.cone_slots), 6)),
        efc_force=t(rng.randn(B, lay.n_simple)), efc=SimpleNamespace(pyr_sel=None),
        contacts=pcol.Contacts(t(feat)))
    got = _check_forces(jm, dm, fwd)
    assert bool(got['feet_contact_state'].any()) and bool(got['invalid_contact'].any())
