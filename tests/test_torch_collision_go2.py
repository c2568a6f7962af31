"""The port's narrow phase on go2 against the JAX package's per-env `collide`,
group by group over the slot ranges of the static layout, in f64.

Both sides take the same geom poses (the reference's FK), so only the
narrow phase is compared. States: 8 seeded tumbled states (base shifted and
tilted, joints +-0.7 rad off the keyframe, as tests/test_collision_bt.py
makes them) and the keyframe lowered 2 cm into the floor, where the floor
groups touch; then, for the robot's own pairs, 16 self-collision states
(joints +-2.5 rad off the keyframe) and 4 with the front and hind feet
pressed together (hips adducted). Bars (both sides compute the same f64
formulas, sums in another order):
* dist within 1e-9 on every slot; a dropped CCD slot is 1e6 on both sides;
* pos and normal within 1e-9 on every slot with dist < 0.01.

The capsule-box CCD has one tie these states do not reach: a capsule lying
along a box face leaves the refined normal perpendicular to the capsule
axis to rounding, and the sign of that rounding picks the capsule end where
a perturbed witness starts (and so which witnesses dedup). On such a pair
the reference's own per-env and batched (`collide_bt`) paths disagree with
each other, so a new state that fails only there points at the tie.

go2/stairs adds the world box-sphere and box-capsule groups; they are run
on the reference alone through `collision_bt._SubsetModel`.
"""

import dataclasses
import types
import zlib

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu.physics.kinematics import fk as jfk
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import collision as pcol
from test_torch_mixed import fast_jit

TOL = 1e-9
NEAR = 0.01
DROPPED = 1e6
N_TUMBLED, N_SELF, N_FEET = 8, 16, 4
GO2_FLAT_GROUPS = ['plane-sphere', 'plane-capsule', 'plane-box', 'sphere-sphere',
                   'sphere-capsule', 'sphere-box', 'capsule-capsule', 'capsule-box',
                   'box-box']


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(jm, B, seed, joint_noise):
    """Tumbled states around the keyframe (tests/test_collision_bt.py)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (B, 1))
    qpos[:, 0:2] += rng.uniform(-0.3, 0.3, (B, 2))
    qpos[:, 2] += rng.uniform(-0.05, 0.25, B)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    alpha = rng.uniform(0, 1, (B, 1))
    quat = (1 - alpha) * np.array([1.0, 0, 0, 0]) + alpha * quat
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-joint_noise, joint_noise, (B, jm.nq - 7))
    return qpos


def _feet_together(jm, B, seed):
    """The keyframe lifted off the floor with the front and the hind feet
    pressed together (hip adduction 0.42-0.54 rad), other joints +-0.05."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (B, 1))
    qpos[:, 2] += 0.1
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, jm.nq - 7))
    ad = np.linspace(0.42, 0.54, B)
    qpos[:, [7, 13]] = -ad[:, None]
    qpos[:, [10, 16]] = ad[:, None]
    return qpos


def _poses(jm, qpos):
    kin = fast_jit(jax.vmap(lambda q: jfk(jm, q)))(qpos)
    return np.asarray(kin.geom_xpos), np.asarray(kin.geom_xmat)


def _port_model(jm):
    return to_device(from_arrays({f.name: getattr(jm, f.name)
                                  for f in dataclasses.fields(jm)}), 'cpu', torch.float64)


def _port_feat(dm, xpos, xmat):
    kin = types.SimpleNamespace(geom_xpos=torch.tensor(xpos), geom_xmat=torch.tensor(xmat))
    return pcol.collide(dm, kin).feat.numpy()


def _group_slots(m):
    """{'type1-type2': slot slice} in the static layout's order."""
    out, off = {}, 0
    for t1, t2, g1, _ in pcol._pair_groups(m):
        n = len(g1) * pcol._NCON_TABLE[(t1, t2)]
        out[f'{pcol._GEOM_NAMES[t1]}-{pcol._GEOM_NAMES[t2]}'] = slice(off, off + n)
        off += n
    return out


def _check(got, ref, where):
    """The bars of the module docstring on (B, 7, S) feature blocks; returns
    the count of near-contact slots compared."""
    assert got.shape == ref.shape, where
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=TOL, err_msg=f'{where} dist')
    dropped = ref[:, 0] == DROPPED
    assert np.array_equal(got[:, 0] == DROPPED, dropped), f'{where}: dropped slots differ'
    near = ref[:, 0] < NEAR
    err = np.abs(got[:, 1:] - ref[:, 1:]) * near[:, None]
    assert err.max(initial=0.0) < TOL, f'{where}: near-contact pos/normal differ by {err.max()}'
    return int(near.sum())


@pytest.fixture(scope='module')
def go2_flat():
    jm = jload('go2', 'flat')
    dm = _port_model(jm)
    key = np.asarray(jm.key_qpos[0]).copy()
    key[2] -= 0.02
    seed = zlib.crc32(b'go2/flat')
    qpos = np.concatenate([_states(jm, N_TUMBLED, seed, 0.7), key[None],
                           _states(jm, N_SELF, seed + 1, 2.5),
                           _feet_together(jm, N_FEET, seed + 2)])
    xpos, xmat = _poses(jm, qpos)
    ref = np.asarray(fast_jit(jax.vmap(lambda xp, xm: jcol.collide(
        jm, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    got = _port_feat(dm, xpos, xmat)
    return jm, dm, ref, got


def test_go2_flat_layout(go2_flat):
    jm, dm, ref, got = go2_flat
    slots = _group_slots(dm.m)
    assert list(slots) == GO2_FLAT_GROUPS
    assert pcol.total_contact_slots(dm.m) == jcol.total_contact_slots(jm) == 1180
    assert got.shape == ref.shape == (N_TUMBLED + 1 + N_SELF + N_FEET, 7, 1180)


@pytest.mark.parametrize('group', GO2_FLAT_GROUPS)
def test_collide_matches_per_env_collide(go2_flat, group):
    _, dm, ref, got = go2_flat
    sl = _group_slots(dm.m)[group]
    near = _check(got[:, :, sl], ref[:, :, sl], f'go2/flat {group}')
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'


@pytest.mark.parametrize('group', ['box-sphere', 'box-capsule'])
def test_stairs_world_box_groups(group):
    jm = jload('go2', 'stairs')
    dm = _port_model(jm)
    t1, t2 = (pcol.GEOM_BOX, pcol.GEOM_SPHERE if group == 'box-sphere' else pcol.GEOM_CAPSULE)
    specs = [s for s in jcol.contact_layout(jm) if (jm.geom_type[s.geom1],
                                                    jm.geom_type[s.geom2]) == (t1, t2)]
    sub = jbt._SubsetModel(jm, specs)
    # tumbled states on the flight (steps of 5 cm rise every 10 cm from x = 1.05)
    rng = np.random.default_rng(zlib.crc32(f'go2/stairs/{group}'.encode()))
    qpos = _states(jm, 8, int(rng.integers(1 << 30)), 0.7)
    qpos[:, 0] = rng.uniform(1.2, 2.5, 8)
    qpos[:, 2] += 0.5 * (qpos[:, 0] - 1.05) - 0.1
    xpos, xmat = _poses(jm, qpos)
    ref = np.asarray(fast_jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    got = _port_feat(dm, xpos, xmat)[:, :, _group_slots(dm.m)[group]]
    near = _check(got, ref, f'go2/stairs {group}')
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'
