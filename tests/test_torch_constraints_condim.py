"""The port's unculled per-slot contact rows, and the Newton solve on them,
against the JAX package's, in f64.

go1/flat (elliptic) emits its 419 condim-1 slots as one row each (J =
dir_0) beside its cone blocks, culled to 32 of 202 (ns = 24 + 419 = 443);
mini_cheetah/flat (pyramidal, condims 1 and 3) emits every slot unculled,
one row per condim-1 slot and 4 (J = dir_0 +- mu_i dir_i) per condim-3
slot (ns = 12 + 242 + 37 x 4 = 402). Both sides get the same seeded
contact features (dist U(-0.01, 0.02): some slots within margin, some
past it), poses and velocities, so the narrow phase is not compiled here;
every Efc field is held to the reference's per-env `make_efc` (vmapped) at
1e-9 (bool and integer fields exactly, `pyr_sel` None on both), then the
plain Newton solve of those rows at a cap of 30 (converged) to the
reference's vmapped `solve`, from a_smooth and from a warm start.
"""

import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu.physics import solver as jsol
from gym_quadruped_tpu.physics.collision import Contacts as JContacts
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import dynamics as pdyn
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_step import _close

MAX_CONE = 32
B = 3
NS = {'go1': 443, 'mini_cheetah': 402}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(jm, qpos, S, rng):
    dist = rng.uniform(-0.01, 0.02, (B, S))
    pos = qpos[:, None, :3] + rng.uniform(-0.3, 0.3, (B, S, 3))
    n = rng.randn(B, S, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([dist[:, None], pos.transpose(0, 2, 1), n.transpose(0, 2, 1)], 1)


@pytest.fixture(scope='module', params=list(NS))
def rows(request):
    robot = request.param
    jm = jload(robot, 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    rng = np.random.RandomState(zlib.crc32(f'{robot}/condim'.encode()) % 2**31)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, jm.nq - 7))
    qvel = 0.5 * rng.randn(B, jm.nv)
    feat = _features(jm, qpos, pcol.total_contact_slots(dm.m), rng)
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin = pkin.fk(dm, q)
    cdof = pkin.cdof(dm, kin)
    efc = pcon.make_efc(dm, kin, q, v, pcol.Contacts(torch.as_tensor(feat)), cdof,
                        max_cone=MAX_CONE)

    def one(q_, v_, f_):
        k = jkin.fk(jm, q_)
        return jcon.make_efc(jm, k, q_, v_, JContacts(f_), jkin.cdof(jm, k), max_cone=MAX_CONE)
    ref = jax.jit(jax.vmap(one))(qpos, qvel, feat)
    M = pdyn.mass_matrix(dm, kin, cdof)
    return robot, jm, dm, efc, ref, M


def test_per_slot_rows_match_reference(rows):
    robot, jm, dm, efc, ref, _ = rows
    assert efc.J.shape[1] == NS[robot] and efc.pyr_sel is None and ref.pyr_sel is None
    for f in dataclasses.fields(pcon.Efc):
        got, want = getattr(efc, f.name), getattr(ref, f.name)
        if f.name == 'pyr_sel':
            continue
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, f'{robot} {f.name}: {got.shape} {want.shape}'
        if want.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, want, err_msg=f'{robot} {f.name}')
        else:
            _close(got, want, 1e-9, f'{robot} {f.name}')
    # some contact rows in, some out
    n_rows = len(pcon.simple_slot_rows(pcon.constraint_layout(dm.m))[0])
    contact = efc.active[:, NS[robot] - n_rows:]
    assert bool(contact.any()) and not bool(contact.all())


@pytest.mark.parametrize('warm', [False, True])
def test_newton_on_per_slot_rows_matches_reference(rows, warm):
    robot, jm, _, efc, _, M = rows
    lay = jcon.constraint_layout(jm)
    a_smooth = np.random.RandomState(7).randn(B, jm.nv)
    w = np.random.RandomState(8).randn(B, jm.nv) if warm else a_smooth
    jefc = jcon.Efc(**{f.name: (None if getattr(efc, f.name) is None
                                else getattr(efc, f.name).numpy())
                       for f in dataclasses.fields(efc)})
    want = jax.jit(jax.vmap(lambda M_, a, e, w_: jsol.solve(jm, lay, M_, a, e, warmstart=w_,
                                                            iterations=30)))(
        M.numpy(), a_smooth, jefc, w)
    got = nf.solve_batched(M, torch.as_tensor(a_smooth), efc,
                           warmstart=torch.as_tensor(w) if warm else None, iterations=30)
    assert bool((got[1] != 0).any())
    for g, r, name in zip(got, want, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, np.asarray(r), 1e-9, f'{robot} {name}')
