"""The port's cylinder pair groups against the JAX package's narrow phase, on
b2/flat and go1/flat, in f64, group by group over the slot ranges of the
static layout.

Both sides take the same geom poses (the reference's FK). The reference runs
each cylinder group alone (`collision_bt._SubsetModel`) through both of its
paths: the per-env `collide`, vmapped, and the batch-trailing `collide_bt`.
States: 8 seeded tumbled states (base shifted and tilted, joints +-0.7 rad
off the keyframe, as tests/test_collision_bt.py makes them), the keyframe
lowered 2 cm into the floor, 16 self-collision states (joints +-2.5 rad off
the keyframe) and 4 upright-cylinder states: the base rolled or pitched by
+-90 degrees, so that the hip (b2, go1) or trunk (go1) cylinders stand on
their caps, lowered until the lowest cap is 5 mm into the floor. There the
plane-cylinder rim direction vanishes to rounding and the group takes its
fallback, the plane's x axis. Bars (both sides compute the same f64
formulas, sums in another order):
* dist within 1e-9 on every slot; a dropped CCD slot is 1e6 on both sides;
* pos and normal within 1e-9 on every slot with dist < 0.01.

Capsule-cylinder and cylinder-cylinder pairs are capsule pairs of the
cylinders' radius and half-length on both sides (the reference's
documented approximation). Cylinder-box runs the CCD of physics/ccd.py with
the cylinder's support, face and clip functions. Like capsule-box, it is
chaotic on the side-line tie: a cylinder lying along a box face touches it
along a segment, the refined normal is perpendicular to the cylinder axis
to rounding, and where a perturbed configuration's witness lands on the
segment depends on rounding (its normal tilts the axis by only ~1e-4, below
the face tolerance). 11 of b2's 16 near-contact cylinder-box pairs in these
states lie along a face. On one of them (a self-collision state, a hip
cylinder against a box) the reference's jitted per-env and batched paths
agree with each other, and its un-jitted call of the same pair agrees with
the port, 8.3 mm apart in pos. So on such pairs dist and normal are held
against both jitted paths, and pos against the reference's un-jitted
`_cyl_box_ccd` of the pair alone, to the same 1e-9.
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu_torch.models.model import GEOM_CYLINDER
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_collision_go2 import (
    NEAR,
    TOL,
    _check,
    _group_slots,
    _port_feat,
    _port_model,
    _poses,
    _states,
)
from test_torch_mixed import fast_jit

N_TUMBLED, N_SELF = 8, 16
GROUPS = {'b2': ['plane-cylinder', 'sphere-cylinder', 'cylinder-box'],
          'go1': ['plane-cylinder', 'sphere-cylinder', 'capsule-cylinder', 'cylinder-cylinder']}
CASES = [(robot, group) for robot, groups in GROUPS.items() for group in groups]
# base orientations (w, x, y, z) that stand the cylinders on their caps
UPRIGHT = np.array([[1.0, 1.0, 0.0, 0.0], [1.0, -1.0, 0.0, 0.0],
                    [1.0, 0.0, 1.0, 0.0], [1.0, 0.0, -1.0, 0.0]]) / np.sqrt(2.0)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _upright(jm, dm):
    """The keyframe turned by each of UPRIGHT, lowered until the lowest
    cylinder cap is 5 mm into the floor."""
    m = dm.m
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (len(UPRIGHT), 1))
    qpos[:, 3:7] = UPRIGHT
    kin = pkin.fk(dm, torch.as_tensor(qpos))
    cyl = np.flatnonzero(m.geom_type == GEOM_CYLINDER)
    axis = kin.geom_xmat[:, cyl, :, 2].numpy()
    low = (kin.geom_xpos[:, cyl, 2].numpy() - np.abs(axis[..., 2]) * m.geom_size[cyl, 1]
           - np.hypot(axis[..., 0], axis[..., 1]) * m.geom_size[cyl, 0])
    qpos[:, 2] -= low.min(1) + 0.005
    return qpos


@pytest.fixture(scope='module')
def scene():
    """robot -> (jm, dm, xpos, xmat, the port's feat), made once."""
    made = {}

    def get(robot):
        if robot not in made:
            jm = jload(robot, 'flat')
            dm = _port_model(jm)
            key = np.asarray(jm.key_qpos[0]).copy()
            key[2] -= 0.02
            seed = zlib.crc32(f'{robot}/flat'.encode())
            qpos = np.concatenate([_states(jm, N_TUMBLED, seed, 0.7), key[None],
                                   _states(jm, N_SELF, seed + 1, 2.5), _upright(jm, dm)])
            xpos, xmat = _poses(jm, qpos)
            made[robot] = jm, dm, xpos, xmat, _port_feat(dm, xpos, xmat)
        return made[robot]
    return get


def _subset(jm, group):
    """The reference model narrowed to one pair group."""
    t1, t2 = (next(t for t, name in pcol._GEOM_NAMES.items() if name == g)
              for g in group.split('-'))
    specs = [s for s in jcol.contact_layout(jm)
             if (int(jm.geom_type[s.geom1]), int(jm.geom_type[s.geom2])) == (t1, t2)]
    assert specs, group
    return jbt._SubsetModel(jm, specs)


def _check_cyl(dm, group, xpos, xmat, got, ref, where, eager=False):
    """`_check`; on the cylinder-box pairs that sit on the side-line tie (a
    near contact whose normal is perpendicular to the cylinder axis to
    rounding), pos is left out, and with `eager` held instead against the
    reference's un-jitted `_cyl_box_ccd` of the pair alone. Returns the
    count of near-contact slots compared."""
    if group != 'cylinder-box':
        return _check(got, ref, where)
    _, _, g1, g2 = next(g for g in pcol._pair_groups(dm.m)
                        if g[:2] == (GEOM_CYLINDER, pcol.GEOM_BOX))
    B, G = got.shape[0], len(g1)
    n0 = ref[:, 4:7].reshape(B, 3, G, 5)[..., 0].transpose(0, 2, 1)   # (B, G, 3)
    d0 = ref[:, 0].reshape(B, G, 5)[..., 0]
    tie = (np.abs((n0 * xmat[:, g1][..., 2]).sum(-1)) < 1e-12) & (d0 < NEAR)   # (B, G)
    print(f'{where}: {int(tie.sum())} of {int((d0 < NEAR).sum())} near-contact pairs on the '
          f'side-line tie')
    held = got.copy()
    held[:, 1:4] = np.where(np.repeat(tie, 5, 1)[:, None], ref[:, 1:4], got[:, 1:4])
    near = _check(held, ref, where)
    size = np.asarray(dm.m.geom_size)
    for b, g in zip(*np.nonzero(tie) if eager else ()):
        i1, i2 = g1[g], g2[g]
        d, pos, _ = jcol._cyl_box_ccd(xpos[b, i1], xmat[b, i1], size[i1, 0], size[i1, 1],
                                      xpos[b, i2], xmat[b, i2], size[i2])
        ok = np.asarray(d) < NEAR
        pos_got = got[b, 1:4, 5 * g:5 * g + 5].T
        err = np.abs(pos_got - np.asarray(pos))[ok].max(initial=0.0)
        assert err < TOL, f'{where}: state {b} pair {g} on the tie: pos differs by {err}'
    return near


def test_cylinder_layouts(scene):
    for robot, groups in GROUPS.items():
        jm, dm, _, _, got = scene(robot)
        slots = _group_slots(dm.m)
        assert set(groups) <= set(slots), robot
        assert got.shape[2] == pcol.total_contact_slots(dm.m) == jcol.total_contact_slots(jm)


@pytest.mark.parametrize('robot,group', CASES, ids=[f'{r}-{g}' for r, g in CASES])
def test_cylinder_group_matches_per_env_collide(scene, robot, group):
    jm, dm, xpos, xmat, got = scene(robot)
    sub = _subset(jm, group)
    ref = np.asarray(fast_jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    near = _check_cyl(dm, group, xpos, xmat, got[:, :, _group_slots(dm.m)[group]], ref,
                      f'{robot}/flat {group}', eager=True)
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'


@pytest.mark.parametrize('robot,group', CASES, ids=[f'{r}-{g}' for r, g in CASES])
def test_cylinder_group_matches_collide_bt(scene, robot, group):
    jm, dm, xpos, xmat, got = scene(robot)
    ref = np.asarray(fast_jit(lambda xp, xm: jbt.collide_bt(_subset(jm, group), xp, xm))(
        xpos, xmat)).transpose(2, 0, 1)
    near = _check_cyl(dm, group, xpos, xmat, got[:, :, _group_slots(dm.m)[group]], ref,
                      f'{robot}/flat {group} (bt)')
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'


@pytest.mark.parametrize('robot', list(GROUPS))
def test_upright_cylinders_take_the_fallback_rim(scene, robot):
    # the upright states reach `norm <= 1e-10` and touch the floor there
    jm, dm, xpos, xmat, got = scene(robot)
    m = dm.m
    n_up = len(UPRIGHT)
    _, _, g1, g2 = next(g for g in pcol._pair_groups(m) if g[:2] == (pcol.GEOM_PLANE,
                                                                       GEOM_CYLINDER))
    n = xmat[-n_up:, g1][..., 2]
    axis = xmat[-n_up:, g2][..., 2]
    proj = -n + axis * (axis * n).sum(-1, keepdims=True)
    upright = np.linalg.norm(proj, axis=-1) <= 1e-10                 # (n_up, G)
    dist = got[-n_up:, 0, _group_slots(m)['plane-cylinder']].reshape(n_up, len(g2), 3)
    assert bool((upright & (dist.min(-1) < 0)).any()), 'no upright cylinder touches the floor'
