"""The port's mesh narrow phase against the JAX package in f64: plane-mesh,
sphere-mesh and mesh-mesh on mini_cheetah/flat and hyqreal1/flat, box-mesh
by a direct call, and the hull helpers of `physics/ccd.py` alone.

The states are the keyframe lowered up to 4 cm into the floor with every
joint moved by up to 1.5 rad, so that feet and shins press into the floor
and folded legs press their hulls into one another; the poses come from
the port's FK and go to both sides. The reference runs its `collide` on
the mesh groups alone (`collision_bt._SubsetModel`), one program per robot.
Bars: 1e-9 on every dist and normal, and on pos of every slot with dist <
0.01 off the support ties. A tie slot is one whose hull support is decided
by rounding: the two sides pick different vertices of equal support
(within 1e-9 of each other), so the witness moves along a face or an edge
while depth and normal agree. Each robot's tie slots are counted and
printed, and may be at most a few of its near slots: none on these 24
states (mini_cheetah 24 near plane-mesh slots, 10 sphere-mesh, 33
mesh-mesh; hyqreal1 23, 15 and 177).
"""

import types
import zlib

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import ccd as jccd
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu_torch.models.model import GEOM_MESH
from gym_quadruped_tpu_torch.physics import ccd as pccd
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_collision_go2 import _port_model

TOL = 1e-9
NEAR = 0.01
B = 24
GROUPS = ['plane-mesh', 'sphere-mesh', 'mesh-mesh']
T = torch.tensor


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_states(jm, seed):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.key_qpos[0]), (B, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.04, B)
    qpos[:, 7:] += rng.uniform(-1.5, 1.5, (B, jm.nq - 7))
    return qpos


def _mesh_slots(m):
    """{'type1-type2': slot slice} of the mesh groups, in the layout's order,
    and their specs."""
    out, specs, off = {}, [], 0
    layout = pcol.contact_layout(m)
    for t1, t2, g1, _ in pcol._pair_groups(m):
        n = len(g1) * pcol._NCON_TABLE[(t1, t2)]
        if GEOM_MESH in (t1, t2):
            out[f'{pcol._GEOM_NAMES[t1]}-{pcol._GEOM_NAMES[t2]}'] = slice(off, off + n)
            specs += [s for s in layout if (int(m.geom_type[s.geom1]), int(m.geom_type[s.geom2]))
                      == (t1, t2)]
        off += n
    return out, specs


@pytest.fixture(scope='module', params=['mini_cheetah', 'hyqreal1'])
def robot(request):
    name = request.param
    jm = jload(name, 'flat')
    dm = _port_model(jm)
    kin = pkin.fk(dm, T(_mesh_states(jm, zlib.crc32(f'{name}/mesh'.encode()))))
    xpos, xmat = kin.geom_xpos.numpy(), kin.geom_xmat.numpy()
    slots, specs = _mesh_slots(dm.m)
    sub = jbt._SubsetModel(jm, specs)
    ref = np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    got = pcol.collide(dm, types.SimpleNamespace(geom_xpos=T(xpos), geom_xmat=T(xmat))).feat
    mesh = np.concatenate([got.numpy()[:, :, sl] for sl in slots.values()], 2)
    off, ref_by = 0, {}
    for g, sl in slots.items():
        n = sl.stop - sl.start
        ref_by[g] = (mesh[:, :, off:off + n], ref[:, :, off:off + n])
        off += n
    return name, ref_by


TIES = {}


@pytest.mark.parametrize('group', GROUPS)
def test_mesh_group_matches_reference(robot, group):
    name, by = robot
    got, ref = by[group]
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=TOL, err_msg=f'{group} dist')
    near = ref[:, 0] < NEAR
    assert near.sum() > 0, f'{name} {group}: no slot in contact'
    np.testing.assert_allclose(got[:, 4:][np.broadcast_to(near[:, None], got[:, 4:].shape)],
                               ref[:, 4:][np.broadcast_to(near[:, None], ref[:, 4:].shape)],
                               rtol=0, atol=TOL, err_msg=f'{group} normal')
    perr = np.linalg.norm(got[:, 1:4] - ref[:, 1:4], axis=1)            # (B, S)
    ties = near & (perr > TOL)
    TIES[(name, group)] = (int(ties.sum()), int(near.sum()))
    print(f'{name} {group}: {int(near.sum())} near slots, {int(ties.sum())} tie slots '
          f'(pos apart by up to {perr[ties].max(initial=0.0):.3g} m)')
    assert ties.sum() <= max(2, near.sum() // 20), f'{name} {group}: {ties.sum()} tie slots'


# ---------------------------------------------------------------------------------
# box-mesh by a direct call, and the hull helpers alone
# ---------------------------------------------------------------------------------

def _hull(jm, g):
    did = int(jm.geom_dataid[g])
    return np.asarray(jm.mesh_vert[did]), int(jm.mesh_vertnum[did])


def test_box_mesh_direct_call():
    # a box (as its 8 corners) pressed into mini_cheetah's hulls at seeded
    # poses, against the reference's _mesh_mesh (what its box-mesh group runs)
    jm = jload('mini_cheetah', 'flat')
    rng = np.random.default_rng(zlib.crc32(b'box-mesh'))
    meshes = [g for g in range(jm.ngeom) if int(jm.geom_type[g]) == GEOM_MESH][:3]
    G, n = len(meshes), 6
    V2 = np.stack([_hull(jm, g)[0] for g in meshes])
    size = rng.uniform(0.02, 0.08, (G, 3))
    V1 = pcol._BOX_CORNER_SIGNS[None] * size[:, None, :]
    rots = lambda k: np.stack([_rot(q) for q in rng.normal(size=(k, 4))])
    p2 = rng.uniform(-0.05, 0.05, (n, G, 3))
    p1 = p2 + rng.normal(size=(n, G, 3)) * 0.06
    R1, R2 = rots(n * G).reshape(n, G, 3, 3), rots(n * G).reshape(n, G, 3, 3)
    margin = np.full(G, 1e-3)
    ref = jax.jit(jax.vmap(jax.vmap(lambda a, Ra, Wa, b, Rb, Wb, mg: jcol._mesh_mesh(
        a, Ra, Wa, 8, b, Rb, Wb, 0, mg), in_axes=(0, 0, 0, 0, 0, 0, 0)),
        in_axes=(0, 0, None, 0, 0, None, None)))(p1, R1, V1, p2, R2, V2, margin)
    dm = _port_model(jm)
    did = np.asarray(jm.geom_dataid)[meshes]
    hs1 = pcol.hull_set(dm, 'box', np.arange(G), V1, np.full(G, 8))
    hs2 = pcol.hull_set(dm, 'meshes', did, V2, np.asarray(jm.mesh_vertnum)[did])
    got = pcol._mesh_mesh(T(p1), T(R1), hs1, T(p2), T(R2), hs2, T(margin))
    d_ref, d = np.asarray(ref[0]), got[0].numpy()
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=TOL)
    kept = d_ref < 1e5
    assert kept.sum() > 0
    np.testing.assert_allclose(got[2].numpy()[kept], np.asarray(ref[2])[kept], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1].numpy()[kept], np.asarray(ref[1])[kept], rtol=0, atol=TOL)


def _rot(q):
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def test_hull_helpers_match_reference():
    jm = jload('hyqreal1', 'flat')
    g = [g for g in range(jm.ngeom) if int(jm.geom_type[g]) == GEOM_MESH][0]
    V, nv = _hull(jm, g)
    V = V[:nv]
    rng = np.random.default_rng(zlib.crc32(b'hull-helpers'))
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a face-aligned direction: two vertices of equal support, the centroid
    box = pcol._BOX_CORNER_SIGNS * [0.1, 0.2, 0.3]
    d_tie = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 1.0] / np.sqrt(2)])
    for dirs, verts in ((d, V), (d_tie, box)):
        np.testing.assert_allclose(pccd.support_verts(T(dirs), T(verts)).numpy(),
                                   np.asarray(jccd.support_verts(dirs, verts)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(pccd.supval_verts(T(dirs), T(verts)).numpy(),
                                   np.asarray(jccd.supval_verts(dirs, verts)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pccd.support_verts(T(d_tie[:1]), T(box)).numpy(),
                               [[0.0, 0.0, 0.3]], atol=1e-15)
    # the face triangle and the Frank-Wolfe projection, from inside and out
    ref_face = np.stack([np.asarray(jccd.hull_face(x, V)) for x in d])
    np.testing.assert_allclose(pccd.hull_face(T(d), T(V)).numpy(), ref_face, rtol=0, atol=1e-12)
    pts = V.mean(0) + rng.normal(size=(40, 3)) * 0.2
    np.testing.assert_allclose(pccd.clip_into_hull(T(pts), T(V)).numpy(),
                               np.asarray(jccd.clip_into_hull(pts, V)), rtol=0, atol=1e-12)
    # the tilts of the mesh pairs, and the margin-aware manifold from a pos0
    for eps in (1e-3, 1.75e-3):
        for a, b in zip(pccd.perturb_rots(T(d), eps), jccd.perturb_rots(d, eps)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    depth0 = rng.uniform(-2e-3, 2e-3, 40)
    depth_p = depth0[:, None] + rng.uniform(-1e-3, 1e-3, (40, 4))
    pos_p = rng.normal(size=(40, 4, 3)) * 1e-4
    pos_p[::3, 2] = pos_p[::3, 1] + 2e-5          # duplicates within the dedup tolerance
    pos0 = pos_p[:, 0] + rng.normal(size=(40, 3)) * 3e-5
    margin = np.full(40, 1e-3)
    ref = jccd.manifold_from_perturbed(depth0, d, depth_p, pos_p, d[:, None].repeat(4, 1),
                                       margin=1e-3, pos0=pos0)
    got = pccd.manifold_from_perturbed(T(depth0), T(d), T(depth_p), T(pos_p),
                                       T(d[:, None].repeat(4, 1)), margin=T(margin), pos0=T(pos0))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    assert 0 < (got[0].numpy() < 1e5).sum() < 200
