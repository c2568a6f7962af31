"""The port's heightfield narrow phase, part 1, against the JAX package in
f64: `hfield_height`, the two closest-point-on-triangle routines (the CCD's
`ccd.clip_onto_triangle` and the sphere path's `_closest_point_triangle`,
kept apart: their degenerate denominators and region orders differ), the
sphere-triangle contact, and the sphere and capsule groups on go2/perlin.

The unit functions take seeded inputs, and for the triangles a point in
each of Ericson's 7 regions (3 vertices, 3 edges, the face) of seeded
triangles, plus degenerate triangles (two coincident vertices, collinear
vertices). The sphere group is held on seeded spheres over the terrain, a
sphere on a grid vertex (the 6 prisms around it each give a contact), one
on a cell diagonal (2), and spheres at the grid's border (a clamped cell
repeats another and is dropped, dist 1e6). The groups then run through
`collide` on seeded tumbled go2/perlin states, against the reference's
per-env `collide` and its batched twin (`collision_bt.collide_bt`). Bars:
1e-9 on every dist, and on pos and normal of every slot with dist < 0.01.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import ccd as jccd
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu_torch.models.model import GEOM_CAPSULE, GEOM_HFIELD, GEOM_SPHERE
from gym_quadruped_tpu_torch.physics import ccd as pccd
from gym_quadruped_tpu_torch.physics import collision as pcol
from test_torch_collision_go2 import (
    TOL,
    _check,
    _group_slots,
    _port_feat,
    _port_model,
    _poses,
    _states,
)

GROUPS = ['hfield-sphere', 'hfield-capsule']
T = torch.tensor


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def go2():
    jm = jload('go2', 'perlin')
    dm = _port_model(jm)
    h = int(np.flatnonzero(np.asarray(jm.geom_type) == GEOM_HFIELD)[0])
    xpos, xmat = _poses(jm, np.asarray(jm.key_qpos[:1]))
    return jm, dm, xpos[0, h], xmat[0, h]


def _triangles(rng, n):
    """n seeded triangles (a, b, c) and, for each, a point in each of the 7
    regions: vertex a, b, c, edge ab, ac, bc, the face; lifted off the
    triangle's plane by +-0.3. Returns a, b, c (7n, 3), p (7n, 3), region
    (7n,)."""
    a = rng.uniform(-1, 1, (n, 3))
    u, v = rng.uniform(0.5, 1.5, (n, 1)) * [1, 0, 0], rng.uniform(0.5, 1.5, (n, 1)) * [0, 1, 0]
    rot = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    b, c = a + np.einsum('nij,nj->ni', rot, u), a + np.einsum('nij,nj->ni', rot, v)
    # barycentric-plane offsets (along ab, along ac) that land in each region
    offs = np.array([[-0.3, -0.3], [1.3, -0.2], [-0.2, 1.3], [0.5, -0.4], [-0.4, 0.5],
                     [0.7, 0.7], [0.2, 0.3]])
    normal = np.cross(b - a, c - a)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    p = (a[:, None] + offs[None, :, :1] * (b - a)[:, None] + offs[None, :, 1:] * (c - a)[:, None]
         + rng.uniform(-0.3, 0.3, (n, 7, 1)) * normal[:, None])
    rep = lambda x: np.repeat(x, 7, 0)
    return rep(a), rep(b), rep(c), p.reshape(-1, 3), np.tile(np.arange(7), n)


def _degenerate(rng, n):
    """Triangles with two coincident vertices and with collinear vertices,
    and seeded points around them."""
    a = rng.uniform(-1, 1, (n, 3))
    d = rng.uniform(-1, 1, (n, 3))
    tris = [(a, a, a + d), (a, a + d, a + d), (a, a + d, a + 2.5 * d), (a, a + d, a - d)]
    a, b, c = (np.concatenate(x) for x in zip(*tris))
    return a, b, c, a + rng.uniform(-1.5, 1.5, a.shape)


def test_hfield_height_matches_reference(go2):
    jm, dm, _, _ = go2
    rng = np.random.default_rng(1)
    # over the grid, past its border (clamped) and on its vertices
    xy = np.concatenate([rng.uniform(-15, 15, (500, 2)),
                         np.stack(np.meshgrid(np.linspace(-14, 14, 11),
                                              np.linspace(-14, 14, 11)), -1).reshape(-1, 2)])
    ref = np.asarray(jax.jit(lambda x, y: jcol.hfield_height(jm, x, y, jnp.float64))(
        xy[:, 0], xy[:, 1]))
    got = pcol.hfield_height(dm, T(xy[:, 0]), T(xy[:, 1])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert ref.max() - ref.min() > 0.4      # the terrain's relief (0 to 0.56 m)


def test_triangle_closest_points_match_reference():
    """Both routines on the 7 regions against the reference's compiled
    functions; on degenerate triangles, where the denominators are zero to
    rounding and the compiled program (which fuses, and contracts products
    into FMAs) and the un-jitted reference part, against the un-jitted
    calls."""
    rng = np.random.default_rng(2)
    a, b, c, p, region = _triangles(rng, 64)
    n = len(region)
    da, db, dc, dp = _degenerate(rng, 16)
    a, b, c, p = (np.concatenate(x) for x in ((a, da), (b, db), (c, dc), (p, dp)))
    clip = pccd.clip_onto_triangle(T(p), T(a), T(b), T(c)).numpy()
    q, face = (x.numpy() for x in pcol._closest_point_triangle(T(p), T(a), T(b), T(c)))
    closest = jax.vmap(jcol._closest_point_triangle)
    for where, refs in (('compiled', (jax.jit(jccd.clip_onto_triangle), jax.jit(closest))),
                        ('un-jitted', (jccd.clip_onto_triangle, closest))):
        part = slice(0, n) if where == 'compiled' else slice(None)
        clip_ref = np.asarray(refs[0](p, a, b, c))
        q_ref, face_ref = (np.asarray(x) for x in refs[1](p, a, b, c))
        np.testing.assert_allclose(clip[part], clip_ref[part], rtol=0, atol=TOL, err_msg=where)
        np.testing.assert_allclose(q[part], q_ref[part], rtol=0, atol=TOL, err_msg=where)
        np.testing.assert_array_equal(face[part], face_ref[part], err_msg=where)
    # every region is reached: the vertex regions return the vertex, only
    # face points are in the face region
    for r, vertex in enumerate((a, b, c)):
        np.testing.assert_array_equal(q[:n][region == r], vertex[:n][region == r])
    np.testing.assert_array_equal(face[:n], region == 6)
    # the two routines part on the degenerate triangles (denominators)
    assert np.abs(clip[n:] - q[n:]).max() > 1e-3


def test_sphere_triangle_matches_reference():
    rng = np.random.default_rng(3)
    a, b, c, p, _ = _triangles(rng, 64)
    r = rng.uniform(0.0, 0.3, len(p))
    ref = [np.asarray(x) for x in jax.jit(jax.vmap(jcol._sphere_triangle))(p, r, a, b, c)]
    got = [x.numpy() for x in pcol._sphere_triangle(T(p), T(r), T(a), T(b), T(c))]
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g, x, rtol=0, atol=TOL)
    assert (ref[0] < 0).any() and (ref[0] > 0).any()


def _sphere_centers(jm, rng, radius, margin):
    """(name, centers (n, 3)) of the sphere cases in the heightfield's
    frame: seeded over the terrain, on grid vertices, on cell diagonals, at
    the grid's border; each 0-8 mm into the raised terrain."""
    sz, n_cells = np.asarray(jm.hfield_size), jm.hfield_ncol - 1
    data = np.asarray(jm.hfield_data, np.float64)
    grid = lambda i: (i / n_cells * 2.0 - 1.0) * sz[0]
    height = lambda i, j: data[j, i] * sz[2] + margin
    cases = {}
    xy = rng.uniform(-13, 13, (16, 2))
    h = np.array([jcol.hfield_height(jm, x, y, jnp.float64) for x, y in xy]) + margin
    cases['seeded'] = np.c_[xy, h + radius - rng.uniform(-0.01, 0.02, 16)]
    ij = rng.integers(1, n_cells - 1, (8, 2))
    cases['grid vertex'] = np.c_[grid(ij[:, 0]), grid(ij[:, 1]),
                                 height(ij[:, 0], ij[:, 1]) + radius - 0.004]
    t = rng.uniform(0.3, 0.7, 8)
    x, y = grid(ij[:, 0] + t), grid(ij[:, 1] + t)
    zd = ((1 - t) * data[ij[:, 1], ij[:, 0]] + t * data[ij[:, 1] + 1, ij[:, 0] + 1]) * sz[2]
    cases['cell diagonal'] = np.c_[x, y, zd + margin + radius - 0.004]
    edge = sz[0] - rng.uniform(0.0, 0.9 * radius, 8)
    side = rng.uniform(-13, 13, 8)
    pts = np.stack([np.c_[edge, side], np.c_[-edge, side], np.c_[side, edge],
                    np.c_[edge, edge]]).reshape(-1, 2)
    hb = np.array([jcol.hfield_height(jm, x, y, jnp.float64) for x, y in pts]) + margin
    cases['border'] = np.c_[pts, hb + radius - 0.004]
    return cases


def test_hfield_sphere_cases_match_reference(go2):
    jm, dm, hpos, hmat = go2
    spec = next(s for s in jcol.contact_layout(jm)
                if (jm.geom_type[s.geom1], jm.geom_type[s.geom2]) == (GEOM_HFIELD, GEOM_SPHERE))
    radius, margin = float(jm.geom_size[spec.geom2, 0]), spec.margin
    cases = _sphere_centers(jm, np.random.default_rng(4), radius, margin)
    centers = np.concatenate(list(cases.values())) @ hmat.T + hpos
    n = len(centers)
    ref = [np.asarray(x) for x in jax.jit(jax.vmap(lambda c: jcol._hfield_sphere(
        jm, hpos, hmat, c, radius, margin)))(centers)]
    planes = lambda x: [x[None, ..., k] for k in range(3)]
    bt = jax.jit(lambda c: jbt.hfield_sphere_cl(
        jm, planes(np.broadcast_to(hpos, (n, 3))),
        [planes(np.broadcast_to(hmat[i], (n, 3))) for i in range(3)], planes(c), radius,
        margin))(centers)
    bt = [np.stack([np.asarray(s[0])[0] for s in bt], 1),
          np.stack([np.stack(s[1], -1)[0] for s in bt], 1),
          np.stack([np.stack(s[2], -1)[0] for s in bt], 1)]
    got = [x.numpy() for x in pcol._hfield_sphere(dm, T(hpos), T(hmat), T(centers),
                                                  T(radius), T(margin))]
    for other in (ref, bt):
        np.testing.assert_allclose(got[0], other[0], rtol=0, atol=TOL)
        near = other[0] < 0.01
        for g, x in zip(got[1:], other[1:]):
            assert np.abs(g - x)[near].max() < TOL
    # the cases reach what they are for
    d, first = ref[0], 0
    touching = {}
    for name, c in cases.items():
        touching[name] = (d[first:first + len(c)] < 0).sum(1)
        if name == 'border':
            assert (d[first:first + len(c)] == 1e6).any(1).all(), 'no duplicate cell dropped'
        first += len(c)
    assert (touching['grid vertex'] == 6).all(), touching['grid vertex']
    assert (touching['cell diagonal'] == 2).all(), touching['cell diagonal']


@pytest.fixture(scope='module')
def tumbled(go2):
    """16 seeded tumbled go2/perlin states, the base raised by the terrain's
    height under the keyframe, so that feet, calves and trunk grind into it;
    the geom poses and the port's feature block."""
    jm, dm, _, _ = go2
    qpos = _states(jm, 16, zlib.crc32(b'go2/perlin'), 0.7)
    qpos[:, 2] += float(jcol.hfield_height(jm, 0.0, 0.0, jnp.float64)) - 0.27
    xpos, xmat = _poses(jm, qpos)
    return xpos, xmat, _port_feat(dm, xpos, xmat)


def _subset(jm, group):
    t1, t2 = (next(t for t, name in pcol._GEOM_NAMES.items() if name == g)
              for g in group.split('-'))
    specs = [s for s in jcol.contact_layout(jm)
             if (int(jm.geom_type[s.geom1]), int(jm.geom_type[s.geom2])) == (t1, t2)]
    return jbt._SubsetModel(jm, specs)


@pytest.mark.parametrize('group', GROUPS)
def test_group_matches_per_env_collide(go2, tumbled, group):
    jm, dm, _, _ = go2
    xpos, xmat, got = tumbled
    sub = _subset(jm, group)
    ref = np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))
    near = _check(got[:, :, _group_slots(dm.m)[group]], ref, f'go2/perlin {group}')
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'


@pytest.mark.parametrize('group', GROUPS)
def test_group_matches_collide_bt(go2, tumbled, group):
    jm, dm, _, _ = go2
    xpos, xmat, got = tumbled
    ref = np.asarray(jax.jit(lambda xp, xm: jbt.collide_bt(_subset(jm, group), xp, xm))(
        xpos, xmat)).transpose(2, 0, 1)
    near = _check(got[:, :, _group_slots(dm.m)[group]], ref, f'go2/perlin {group} (bt)')
    assert near > 0, f'{group}: no slot in contact to compare pos and normal on'


def test_capsule_interior_samples_reach_contact(go2, tumbled):
    # an interior sample (slots 16-20 of a pair) touches in these states:
    # the calves lie across the terrain
    _, dm, _, _ = go2
    d = tumbled[2][:, 0, _group_slots(dm.m)['hfield-capsule']]
    d = d.reshape(d.shape[0], -1, 21)
    assert (d[..., 16:] < 0).any() and (d[..., 16:] == 1e6).any()
    assert GEOM_CAPSULE in dm.m.geom_type
