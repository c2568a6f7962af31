"""The port's heightfield-mesh narrow phase against the JAX package in f64,
on hyqreal1/perlin and mini_cheetah/perlin: the per-prism CCD with the hull
as its geom (SAT, refinement and snap over every prism of the footprint,
the 8 deepest prisms, the witness with the hull's Frank-Wolfe volume clip
and support triangle) and the 4 deepest hull-vertex samples, merged.

The states start from the keyframe lifted out of the terrain by the env's
rule, lowered until the nearest foot touches, then pressed U(0, 3) cm
further with the joints moved by up to 0.5 rad and the base tilted; the
poses come from the port's FK and go to both sides. The reference runs its
`collide` on the heightfield-mesh group alone (`collision_bt.
_SubsetModel`), one program per robot. Bars: 1e-9 on every dist, and on
pos and normal of every slot with dist < 0.01 off the support ties (a
witness decided by rounding among vertices of equal support; counted and
printed, at most a few of the near slots: none on these states, 67 near
slots on hyqreal1, 41 on mini_cheetah).

Marked `slow` (the tier-1 command runs `-m 'not slow'`): the reference's
heightfield-mesh program (8 prism witnesses, each with Frank-Wolfe hull
clips) takes ~2.5-4 min to compile in x64 per robot, ~5.5 min for the file
on one core:

    python -m pytest tests/test_torch_collision_hfield_mesh.py -q -m slow
"""

import types
import zlib

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import GEOM_HFIELD, GEOM_MESH
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask
from test_torch_collision_go2 import _port_model

TOL = 1e-9
NEAR = 0.01
B = 6
T = torch.tensor

pytestmark = pytest.mark.slow


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(robot, dm):
    """The keyframe lifted out of the terrain, then lowered until the
    nearest foot touches it."""
    key = T(dm.m.key_qpos[:1])
    lifted, _ = QuadrupedEnv(robot, scene='perlin', model=dm)._lift_until_no_contact(key)
    con = pcol.collide(dm, pkin.fk(dm, lifted))
    foot = T(np.any(feet_slot_mask(dm.m) > 0, axis=0))
    i = int(torch.where(foot, con.dist[0], torch.inf).argmin())
    start = lifted[0].numpy().copy()
    start[2] -= max(0.0, float(con.dist[0, i] / con.normal[0, i, 2]))
    return start


@pytest.mark.parametrize('robot', ['hyqreal1', 'mini_cheetah'])
def test_hfield_mesh_matches_reference(robot):
    jm = jload(robot, 'perlin')
    dm = _port_model(jm)
    rng = np.random.default_rng(zlib.crc32(f'{robot}/hfield-mesh'.encode()))
    qpos = np.tile(_start(robot, dm), (B, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.03, B)
    quat = qpos[:, 3:7] + rng.normal(size=(B, 4)) * 0.08
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.5, 0.5, (B, jm.nq - 7))
    kin = pkin.fk(dm, T(qpos))
    xpos, xmat = kin.geom_xpos.numpy(), kin.geom_xmat.numpy()
    key = (GEOM_HFIELD, GEOM_MESH)
    specs = [s for s in pcol.contact_layout(dm.m)
             if (int(dm.m.geom_type[s.geom1]), int(dm.m.geom_type[s.geom2])) == key]
    first = 0
    for t1, t2, g1, _ in pcol._pair_groups(dm.m):
        if (t1, t2) == key:
            break
        first += len(g1) * pcol._NCON_TABLE[(t1, t2)]
    sl = slice(first, first + len(specs) * pcol._NCON_TABLE[key])
    sub = jbt._SubsetModel(jm, [s for s in jcol.contact_layout(jm)
                                if (int(jm.geom_type[s.geom1]), int(jm.geom_type[s.geom2])) == key])
    ref = np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    got = pcol.collide(dm, types.SimpleNamespace(geom_xpos=T(xpos),
                                                 geom_xmat=T(xmat))).feat.numpy()[:, :, sl]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=TOL, err_msg='dist')
    near = ref[:, 0] < NEAR
    assert near.sum() > 0, 'no heightfield-mesh slot in contact'
    err = np.abs(got[:, 1:] - ref[:, 1:]).max(1)                      # (B, S)
    ties = near & (err > TOL)
    print(f'{robot}/perlin hfield-mesh: {int(near.sum())} near slots, {int(ties.sum())} tie '
          f'slots (apart by up to {err[ties].max(initial=0.0):.3g})')
    assert ties.sum() <= max(2, near.sum() // 20), f'{ties.sum()} tie slots'
