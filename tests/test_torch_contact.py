"""The port's narrow phase and constraint assembly against the JAX package's
per-env `collide` and `make_efc`, on spot/flat in f64.

States: the keyframe lowered into the floor (feet in contact) and raised out
of contact, each with seeded joint offsets and velocities. Tolerance 1e-9:
both sides compute the same f64 rows with sums in another order.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import kinematics as pkin

TOL = 1e-9
B = 3


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
    return jm, dm


def _state(jm, dz, seed):
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 2] += dz
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, jm.nq - 7))
    qvel = 0.5 * rng.randn(B, jm.nv)
    return qpos, qvel


def _ref(jm, qpos, qvel, max_cone):
    """Per-env reference: collide + make_efc, one env at a time."""
    def one(q, v):
        kin = jkin.fk(jm, q)
        cd = jkin.cdof(jm, kin)
        con = jcol.collide(jm, kin)
        return con.feat, jcon.make_efc(jm, kin, q, v, con, cd, max_cone=max_cone)
    f = jax.jit(one)
    outs = [f(q, v) for q, v in zip(qpos, qvel)]
    feat = np.stack([np.asarray(o[0]) for o in outs])
    efc = {k.name: np.stack([np.asarray(getattr(o[1], k.name)) for o in outs])
           for k in dataclasses.fields(jcon.Efc) if getattr(outs[0][1], k.name) is not None}
    return feat, efc


def _port(dm, qpos, qvel, max_cone):
    qpos, qvel = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin = pkin.fk(dm, qpos)
    cd = pkin.cdof(dm, kin)
    con = pcol.collide(dm, kin)
    return con, pcon.make_efc(dm, kin, qpos, qvel, con, cd, max_cone=max_cone)


def _check(jm, dm, qpos, qvel, max_cone):
    feat, efc_ref = _ref(jm, qpos, qvel, max_cone)
    con, efc = _port(dm, qpos, qvel, max_cone)
    np.testing.assert_allclose(con.feat.numpy(), feat, rtol=0, atol=TOL)
    assert set(efc_ref) == {f.name for f in dataclasses.fields(efc)
                            if getattr(efc, f.name) is not None}
    for name, ref in efc_ref.items():
        got = getattr(efc, name).numpy()
        assert got.shape == ref.shape, name
        if ref.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            scale = 1 + np.abs(ref).max(initial=0)
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale, err_msg=name)
    return con, efc


@pytest.mark.parametrize('dz,active', [(-0.03, True), (0.3, False)])
def test_collide_and_make_efc_match(spot, dz, active):
    jm, dm = spot
    qpos, qvel = _state(jm, dz, seed=3)
    con, efc = _check(jm, dm, qpos, qvel, max_cone=32)
    assert efc.con_J.shape[1] == 10                   # 4 plane-sphere + 6 sphere-sphere
    assert bool(efc.con_active[:, :4].all()) is active
    # the floor's frame takes the y axis as its helper (strict-< ties)
    floor_frame = pcol.make_frame(con.normal[:, :4])
    np.testing.assert_allclose(floor_frame[..., 1, :].numpy(),
                               np.broadcast_to([0.0, 1.0, 0.0], (B, 4, 3)), atol=1e-12)


def test_top_k_cull_matches(spot):
    """max_cone=4 of 10 slots: the cull keeps the 4 nearest (the distances are
    distinct, so the order of ties never binds)."""
    jm, dm = spot
    qpos, qvel = _state(jm, -0.02, seed=5)
    con, efc = _check(jm, dm, qpos, qvel, max_cone=4)
    assert all(len(set(np.round(row, 12))) == len(row) for row in con.dist.numpy())
    assert efc.con_J.shape[1] == 4
    f = torch.arange(4 * 6, dtype=torch.float64).reshape(1, 4, 6).expand(B, 4, 6)
    full = pcon.scatter_cone_forces(efc.cone_sel, f, 10)
    for b in range(B):
        np.testing.assert_array_equal(full[b, efc.cone_sel[b]].numpy(), f[b].numpy())
        assert float(full[b].abs().sum()) == float(f[b].abs().sum())


ARCHIVES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / 'gym_quadruped_tpu'
                                   / 'models' / 'compiled').glob('*.npz'))


@pytest.mark.parametrize('archive', ARCHIVES)
def test_unported_branches_raise(archive):
    """No branch is left unported: on each of the 20 compiled archives the
    port's `collide` and `make_efc` run on the keyframe (mesh groups, the
    frictionless and mixed-condim rows among them) without raising, and the
    slot count S, the simple rows ns and the cone blocks C equal the
    reference's layout (its culled pyramidal rows for one condim > 1, else
    every simple row; at most 32 cone blocks)."""
    robot, scene = archive.split('-')
    jm = jload(robot, scene)
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    qpos = torch.as_tensor(jm.key_qpos[:1])
    qvel = torch.zeros(1, jm.nv, dtype=torch.float64)
    kin = pkin.fk(dm, qpos)
    con = pcol.collide(dm, kin)
    efc = pcon.make_efc(dm, kin, qpos, qvel, con, pkin.cdof(dm, kin), max_cone=32)
    lay = jcon.constraint_layout(jm)
    ss = lay.simple_con_slots
    condims = set(np.asarray(lay.con_condim)[ss].tolist())
    if len(condims) == 1 and min(condims) > 1:
        ns = len(lay.fl_dofs) + len(lay.lim_jnts) + min(32, len(ss)) * 2 * (min(condims) - 1)
    else:
        ns = lay.n_simple
    assert con.feat.shape == (1, 7, jcol.total_contact_slots(jm))
    assert efc.J.shape[1:] == (ns, jm.nv)
    assert efc.con_J.shape[1] == min(32, len(lay.cone_slots))
    assert bool(torch.isfinite(con.feat).all()) and bool(torch.isfinite(efc.J).all())