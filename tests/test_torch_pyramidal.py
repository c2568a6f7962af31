"""The port's pyramidal contact rows, and the Newton solve on them, against
the JAX package's, in f64.

aliengo/flat, b2/flat and hyqreal2/flat use cone = pyramidal with a uniform
condim of 3 on every contact slot (328, 998 and 173 slots): `make_efc` keeps
the 32 nearest slots of each env and emits 4 one-sided rows per slot, J =
dir_0 +- mu_i dir_i, after the friction-loss and limit rows (ns = 148, 140
and 158).

* `make_efc`: every Efc field, `pyr_sel` among them, within 1e-9 (integer
  and bool fields exactly) of the reference's per-env `make_efc` (vmapped)
  and of `constraints_bt.make_efc_bt` (the assembly of its batched path),
  all three fed the port's contact features, on 4 contact states (the
  keyframe pressed up to 3 cm into the floor, joints +-0.1 rad off, random
  qvel) and the keyframe lowered 10 cm. On aliengo that last state has 8
  slots at one distance across the 32nd place (30 nearer), so the culled
  set depends on the tie rule: the lower slot first, as `jax.lax.top_k`.
* The cull at 6,173 slots (hyqreal2/random_boxes): seeded contact features
  made with numpy (so the reference's narrow phase at that size is never
  compiled), 20 slots nearer than a group of 30 at one distance in every
  env, against both reference assemblies.
* The Newton solve on aliengo's rows of contact states (active rows past
  row 64 among them): `newton_fused.solve_batched` against the reference's
  vmapped `solve` (from a_smooth and from a warm start) and
  `newton_fused.solve_batched_bt` against its `solve_batched`: 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu.physics import solver as jsol
from gym_quadruped_tpu.physics.collision import Contacts as JContacts
from gym_quadruped_tpu.physics.constraints_bt import make_efc_bt
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state

MAX_CONE = 32
NS = {'aliengo': 148, 'b2': 140, 'hyqreal2': 158}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(robot, scene='flat'):
    jm = jload(robot, scene)
    return jm, to_device(from_arrays({f.name: getattr(jm, f.name)
                                      for f in dataclasses.fields(jm)}), 'cpu', torch.float64)


def _port_efc(dm, qpos, qvel, feat=None):
    """The port's rows (and contact features) at qpos, qvel; its own narrow
    phase unless `feat` is given."""
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin = pkin.fk(dm, q)
    con = pcol.collide(dm, kin) if feat is None else pcol.Contacts(torch.as_tensor(feat))
    return con.feat.numpy(), pcon.make_efc(dm, kin, q, v, con, pkin.cdof(dm, kin),
                                           max_cone=MAX_CONE)


def _ref_efcs(jm, qpos, qvel, feat):
    """The reference's rows from the same features: per-env `make_efc`
    (vmapped) and the batched `make_efc_bt`."""
    def one(q, v, f):
        kin = jkin.fk(jm, q)
        return jcon.make_efc(jm, kin, q, v, JContacts(f), jkin.cdof(jm, kin), max_cone=MAX_CONE)

    def batched(q, v, f):
        kin = jax.vmap(lambda x: jkin.fk(jm, x))(q)
        cdof = jax.vmap(lambda k: jkin.cdof(jm, k))(kin)
        return make_efc_bt(jm, jcon.constraint_layout(jm), jnp.transpose(f, (1, 2, 0)), q, v,
                           cdof, kin.subtree_com[:, 0], max_cone=MAX_CONE)
    return (fast_jit(jax.vmap(one))(qpos, qvel, feat),
            fast_jit(batched)(qpos, qvel, feat))


def _check_efc(efc, ref, where):
    for f in dataclasses.fields(pcon.Efc):
        got, want = getattr(efc, f.name), getattr(ref, f.name)
        assert want is not None and got is not None, f'{where} {f.name}'
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, f'{where} {f.name}: {got.shape} {want.shape}'
        if want.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, want, err_msg=f'{where} {f.name}')
        else:
            _close(got, want, 1e-9, f'{where} {f.name}')


@pytest.fixture(scope='module')
def rows():
    """robot -> (jm, dm, qpos, qvel, the port's features and rows), made
    once: 4 contact states and the keyframe lowered 10 cm."""
    made = {}

    def get(robot):
        if robot not in made:
            jm, dm = _models(robot)
            qpos, qvel, _ = _contact_state(jm, 4, seed=51)
            key = np.asarray(jm.key_qpos[0]).copy()
            key[2] -= 0.1
            qpos = np.concatenate([qpos, key[None]])
            qvel = np.concatenate([qvel, np.zeros((1, jm.nv))])
            made[robot] = (jm, dm, qpos, qvel, *_port_efc(dm, qpos, qvel))
        return made[robot]
    return get


@pytest.mark.parametrize('robot', list(NS))
def test_make_efc_matches_reference(rows, robot):
    jm, dm, qpos, qvel, feat, efc = rows(robot)
    lay = pcon.constraint_layout(dm.m)
    assert len(lay.cone_slots) == 0 and set(lay.con_condim.tolist()) == {3}
    assert efc.J.shape[1:] == (NS[robot], jm.nv) and efc.pyr_sel.shape == (len(qpos), MAX_CONE)
    first, per_slot, kept = pcon.pyramidal_rows(lay, MAX_CONE)
    assert (first, per_slot * kept) == (lay.n_fl + lay.n_lim, NS[robot] - first)
    assert bool(efc.active[:, first:].any()), 'no pyramidal row is active'
    per_env, batched = _ref_efcs(jm, qpos, qvel, feat)
    _check_efc(efc, per_env, f'{robot} make_efc')
    _check_efc(efc, batched, f'{robot} make_efc_bt')


def test_cull_ties_match_top_k(rows):
    # aliengo's keyframe lowered 10 cm: 8 slots tied across the 32nd place
    jm, dm, qpos, qvel, feat, efc = rows('aliengo')
    dist = feat[-1, 0]
    kth = np.sort(dist)[MAX_CONE - 1]
    tied, below = int((dist == kth).sum()), int((dist < kth).sum())
    assert below < MAX_CONE < below + tied, (below, tied)
    per_env, batched = _ref_efcs(jm, qpos[-1:], qvel[-1:], feat[-1:])
    for ref in (per_env, batched):
        np.testing.assert_array_equal(efc.pyr_sel[-1].numpy(), np.asarray(ref.pyr_sel)[0])
    # the lower slots of the tied group are the ones kept
    kept = set(efc.pyr_sel[-1].tolist())
    tied_slots = np.flatnonzero(dist == kth)
    assert sorted(kept & set(tied_slots.tolist())) == tied_slots[:MAX_CONE - below].tolist()


def test_cull_at_6173_slots():
    """hyqreal2/random_boxes: 6,173 slots, culled to 32 with ties."""
    jm, dm = _models('hyqreal2', 'random_boxes')
    S = pcol.total_contact_slots(dm.m)
    assert S == 6173
    B = 3
    rng = np.random.RandomState(61)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, jm.nq - 7))
    qvel = 0.5 * rng.randn(B, jm.nv)
    dist = rng.uniform(0.05, 2.0, (B, S))
    for b in range(B):
        slots = rng.permutation(S)
        dist[b, slots[:20]] = rng.uniform(-0.02, 0.0, 20)
        dist[b, slots[20:50]] = 1e-3                   # 30 tied across the 32nd place
    pos = qpos[:, None, :3] + rng.uniform(-0.4, 0.4, (B, S, 3))
    n = rng.randn(B, S, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    feat = np.concatenate([dist[:, None], pos.transpose(0, 2, 1), n.transpose(0, 2, 1)], 1)
    _, efc = _port_efc(dm, qpos, qvel, feat)
    per_env, batched = _ref_efcs(jm, qpos, qvel, feat)
    _check_efc(efc, per_env, 'random_boxes make_efc')
    _check_efc(efc, batched, 'random_boxes make_efc_bt')
    assert bool(efc.active.any())


@pytest.fixture(scope='module')
def newton_rows():
    """M, a_smooth and the rows of 4 aliengo/flat contact states, two of
    them pressed 4 cm further into the floor, from the port's f64 forward
    (its rows held above), for both solvers."""
    jm, dm = _models('aliengo')
    qpos, qvel, ctrl = _contact_state(jm, 4, seed=41)
    qpos[:2, 2] -= 0.04                 # more slots in contact: rows past row 64 active
    fwd = peng.forward(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl)))
    efc = fwd.efc
    assert efc.J.shape[1:] == (148, 18) and efc.con_J.shape[1] == 0
    assert bool(efc.active[:, 64:].any()), 'no active row past row 64'
    jefc = jcon.Efc(**{f.name: getattr(efc, f.name).numpy() for f in dataclasses.fields(efc)})
    return jm, fwd.M.numpy(), fwd.qacc_smooth.numpy(), jefc, efc


@pytest.mark.parametrize('warm', [False, True])
def test_solve_batched_matches_vmapped_solve(newton_rows, warm):
    jm, M, a_smooth, jefc, efc = newton_rows
    lay = jcon.constraint_layout(jm)
    w = np.random.RandomState(42).randn(*a_smooth.shape) if warm else a_smooth
    ref = fast_jit(jax.vmap(lambda M_, a, e, w_: jsol.solve(jm, lay, M_, a, e, warmstart=w_)))(
        M, a_smooth, jefc, w)
    got = nf.solve_batched(torch.as_tensor(M), torch.as_tensor(a_smooth), efc,
                           warmstart=torch.as_tensor(w) if warm else None)
    assert bool((got[1] != 0).any())
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, np.asarray(r), 1e-9, name)


def test_solve_batched_bt_matches_reference_solve_batched(newton_rows):
    jm, M, a_smooth, jefc, efc = newton_rows
    lay = jcon.constraint_layout(jm)
    ref = fast_jit(lambda M_, a, e: jsol.solve_batched(jm, lay, M_, a, e))(M, a_smooth, jefc)
    got = nf.solve_batched_bt(torch.as_tensor(M), torch.as_tensor(a_smooth), efc)
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, np.asarray(r), 1e-9, name)
