"""The port's heightfield narrow phase, part 2: the per-prism CCD
(`collision._hfield_convex_ccd`) through the box group (`_hfield_box`) on
go2/perlin (20 pairs, a 4 x 4-cell footprint: 32 prisms per pair), in f64
against the JAX package's per-env `collide` and its batched twin
(`collision_bt.collide_bt`), both run on the box group alone.

States (both sides take the same geom poses): 8 seeded tumbled states, the
base raised by the terrain's height under the keyframe (the boxes grind into
the terrain, tilted); 4 shallow states, the deepest box corner 3 mm into the
terrain; 2 with a box standing on its lowest corner on a grid vertex that 6
prisms share (their depths tie exactly); 2 at the grid's border, where
clamped cells repeat others: the masked prisms make every prism's one-hot
depth NaN, so the CCD slots of those pairs drop (dist 1e6), and the picks
past the last unmasked prism are empty (zero vertices, direction +z).

Bars: every dist within 1e-9; normal and pos within 1e-9 on every slot with
dist < 0.01, and the empty picks' normal +z. Two exceptions, counted and
printed:
* Support ties. The snap onto the feature axes makes many normals
  perpendicular to a box axis to rounding (|n . axis| ~ 1e-17). The box's
  support point along such a normal is then picked by the sign of that
  rounding, and the witness starts from the corner it picks: pos is left to
  rounding. On seeded go2/perlin states the reference's own per-env and
  batched paths part there by up to 6.8 cm, on 7 of 956 near slots, the
  port and the per-env path on 2. On such slots (the reference's normal
  within 1e-12 of perpendicular to a box axis) dist and normal are held,
  pos is not, and such slots may be at most 2% of the near slots (or 2).
* Prism ties. Where two prisms' depths tie to rounding, their order in the
  8 CCD slots is rounding's too: if a pair's slots do not match one by one,
  its 8 CCD slots are matched as a set (each port slot to one reference
  slot under the same bars).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from gym_quadruped_tpu_torch.models.model import GEOM_HFIELD
from gym_quadruped_tpu_torch.physics import collision as pcol
from test_torch_collision_go2 import DROPPED, NEAR, TOL, _group_slots, _port_feat, _port_model, \
    _poses, _states

K, SLOTS = pcol._HF_CONVEX_K, pcol._HF_CONVEX_K + 4


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def subset(jm, group):
    """The reference model narrowed to one pair group, and that group's
    robot geoms."""
    t1, t2 = (next(t for t, name in pcol._GEOM_NAMES.items() if name == g)
              for g in group.split('-'))
    specs = [s for s in jcol.contact_layout(jm)
             if (int(jm.geom_type[s.geom1]), int(jm.geom_type[s.geom2])) == (t1, t2)]
    return jbt._SubsetModel(jm, specs), np.array([s.geom2 for s in specs])


def terrain_height(jm, xy):
    """The reference's terrain height (world) at world points xy (n, 2)."""
    h = int(np.flatnonzero(np.asarray(jm.geom_type) == GEOM_HFIELD)[0])
    pos = np.asarray(jm.geom_pos)[h]
    z = jax.jit(jax.vmap(lambda x, y: jcol.hfield_height(jm, x, y, jnp.float64)))(
        xy[:, 0] - pos[0], xy[:, 1] - pos[1])
    return np.asarray(z) + pos[2]


def lowest_points(jm, xpos, xmat, geoms, points_fn):
    """(B,) how far each state's lowest point of `geoms` sits above the
    terrain under it; points_fn(p (B, G, 3), R (B, G, 3, 3)) -> (B, G, n, 3)."""
    pts = points_fn(xpos[:, geoms], xmat[:, geoms])
    B = pts.shape[0]
    flat = pts.reshape(-1, 3)
    return (flat[:, 2] - terrain_height(jm, flat[:, :2])).reshape(B, -1).min(1)


def box_corners(size):
    signs = pcol._BOX_CORNER_SIGNS
    return lambda p, R: p[:, :, None] + np.einsum('bgij,gkj->bgki', R, signs * size[:, None])


def border_states(jm, n, seed):
    """n states near the grid's border (a corner of it first), the base
    at the terrain's height there: clamped footprint cells."""
    rng = np.random.default_rng(seed)
    qpos = _states(jm, n, seed, 0.3)
    half = float(np.asarray(jm.hfield_size)[0])
    qpos[:, 0] = np.where(np.arange(n) % 2 == 0, half - 0.15, -half + 0.1)
    qpos[:, 1] = np.where(np.arange(n) % 2 == 0, half - 0.15, rng.uniform(-5, 5, n))
    qpos[:, 2] += terrain_height(jm, qpos[:, :2]) - 0.27
    return qpos


def on_grid_vertex(jm, xpos, xmat, geom, size, rng, into=0.002):
    """Copies of the poses with box `geom` turned by a seeded rotation and
    standing on its lowest corner on a grid vertex (one per state), `into`
    below the raised vertex."""
    h = int(np.flatnonzero(np.asarray(jm.geom_type) == GEOM_HFIELD)[0])
    hpos, hmat = xpos[0, h], xmat[0, h]
    sz, nc = np.asarray(jm.hfield_size), jm.hfield_ncol
    data = np.asarray(jm.hfield_data, np.float64)
    xpos, xmat = xpos.copy(), xmat.copy()
    margin = next(s.margin for s in jcol.contact_layout(jm) if s.geom2 == geom
                  and jm.geom_type[s.geom1] == GEOM_HFIELD)
    for b in range(len(xpos)):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        corners = (pcol._BOX_CORNER_SIGNS * size) @ R.T
        low = corners[np.argmin(corners[:, 2])]
        i, j = rng.integers(20, nc - 20, 2)
        vertex = np.array([(i / (nc - 1) * 2 - 1) * sz[0], (j / (nc - 1) * 2 - 1) * sz[1],
                           data[j, i] * sz[2] + margin - into])
        xpos[b, geom] = hpos + hmat @ vertex - low
        xmat[b, geom] = R
    return xpos, xmat


def check_convex(got, ref, axes, where, tie_axes):
    """The bars of the module docstring on (B, 7, G * 12) feature blocks of
    a heightfield-convex group; axes (B, G, 3, 3) the geoms' rotations,
    tie_axes the columns whose perpendicular normals are support ties.
    Returns {'near': slots compared, 'support ties': tie slots whose pos
    differs, 'reordered': pairs matched as a set}."""
    assert got.shape == ref.shape, where
    B, G = got.shape[0], axes.shape[1]
    g = got.reshape(B, 7, G, SLOTS).transpose(0, 2, 3, 1)
    r = ref.reshape(B, 7, G, SLOTS).transpose(0, 2, 3, 1)
    dots = np.abs(np.einsum('bgsk,bgkj->bgsj', r[..., 4:7], axes))[..., tie_axes]
    tie = dots.min(-1) < 1e-12                                          # (B, G, 12)
    counts = {'near': 0, 'support ties': 0, 'reordered': 0}

    def same(x, y, t):
        """(12,) slot x agrees with slot y under the bars."""
        ok = np.abs(x[..., 0] - y[..., 0]) <= TOL
        ok &= (x[..., 0] == DROPPED) == (y[..., 0] == DROPPED)
        near = y[..., 0] < NEAR
        ok &= ~near | (np.abs(x[..., 4:7] - y[..., 4:7]).max(-1) <= TOL)
        ok &= ~near | t | (np.abs(x[..., 1:4] - y[..., 1:4]).max(-1) <= TOL)
        return ok

    for b in range(B):
        for j in range(G):
            x, y, t = g[b, j], r[b, j], tie[b, j]
            if not same(x, y, t).all():
                # a prism tie: match the CCD slots as a set
                free, order = list(range(K)), []
                for k in range(K):
                    hit = [i for i in free if same(x[i], y[k], t[k])]
                    assert hit, f'{where}: state {b} pair {j} slot {k} has no match: ' \
                                f'{y[k]} against {x}'
                    order.append(hit[0])
                    free.remove(hit[0])
                x = x[order + list(range(K, SLOTS))]
                assert same(x, y, t).all(), f'{where}: state {b} pair {j}: {x} against {y}'
                counts['reordered'] += 1
            near = y[:, 0] < NEAR
            counts['near'] += int(near.sum())
            counts['support ties'] += int((near & t & (np.abs(x[:, 1:4] - y[:, 1:4]).max(-1)
                                                       > TOL)).sum())
            # an empty pick: zero vertices, direction +z, on both sides
            empty = (y[:K, 0] == DROPPED) & (y[:K, 4:7] == [0.0, 0.0, 1.0]).all(-1)
            assert (x[:K][empty, 4:7] == [0.0, 0.0, 1.0]).all(), f'{where}: state {b} pair {j}'
    print(f'{where}: {counts}')
    return counts


@pytest.fixture(scope='module')
def go2():
    jm = jload('go2', 'perlin')
    dm = _port_model(jm)
    sub, geoms = subset(jm, 'hfield-box')
    size = np.asarray(jm.geom_size)[geoms]
    seed = zlib.crc32(b'go2/perlin/hfield-box')
    rng = np.random.default_rng(seed)
    lift = float(jcol.hfield_height(jm, 0.0, 0.0, jnp.float64)) - 0.27
    tumbled = _states(jm, 8, seed, 0.7)
    tumbled[:, 2] += lift
    shallow = _states(jm, 4, seed + 1, 0.3)
    xp, xm = _poses(jm, shallow)
    shallow[:, 2] -= lowest_points(jm, xp, xm, geoms, box_corners(size)) + 0.003
    vertex = np.tile(np.asarray(jm.key_qpos[0]), (2, 1))
    vertex[:, 2] += 0.5 + lift
    qpos = np.concatenate([tumbled, shallow, vertex, border_states(jm, 2, seed + 2)])
    xpos, xmat = (x.copy() for x in _poses(jm, qpos))
    xpos[12:14], xmat[12:14] = on_grid_vertex(jm, xpos[12:14], xmat[12:14], geoms[0], size[0],
                                              rng)
    got = _port_feat(dm, xpos, xmat)[:, :, _group_slots(dm.m)['hfield-box']]
    return jm, dm, sub, geoms, xpos, xmat, got


def test_layout_and_span(go2):
    jm, dm, _, geoms, _, _, got = go2
    assert pcol.hfield_span(dm.m, geoms) == jcol.hfield_span(jm, geoms) == 4
    assert got.shape[2] == 20 * SLOTS
    assert pcol.total_contact_slots(dm.m) == jcol.total_contact_slots(jm) == 1607


@pytest.fixture(scope='module')
def per_env(go2):
    jm, _, sub, _, xpos, xmat, _ = go2
    return np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))


@pytest.fixture(scope='module')
def batched(go2):
    _, _, sub, _, xpos, xmat, _ = go2
    return np.asarray(jax.jit(lambda xp, xm: jbt.collide_bt(sub, xp, xm))(
        xpos, xmat)).transpose(2, 0, 1)


def test_matches_per_env_collide(go2, per_env):
    _, _, _, geoms, _, xmat, got = go2
    counts = check_convex(got, per_env, xmat[:, geoms], 'go2/perlin hfield-box', [0, 1, 2])
    assert counts['near'] > 500
    assert counts['support ties'] <= max(2, 0.02 * counts['near']), counts


def test_matches_collide_bt(go2, batched):
    _, _, _, geoms, _, xmat, got = go2
    counts = check_convex(got, batched, xmat[:, geoms], 'go2/perlin hfield-box (bt)', [0, 1, 2])
    assert counts['near'] > 500
    assert counts['support ties'] <= max(2, 0.02 * counts['near']), counts


def test_reference_paths_part_only_on_support_ties(go2, per_env, batched):
    # the reference's two paths against each other, under the same bars
    _, _, _, geoms, _, xmat, _ = go2
    counts = check_convex(per_env, batched, xmat[:, geoms], 'reference per-env vs bt',
                          [0, 1, 2])
    assert counts['support ties'] > 0


def test_special_states_reach_their_cases(go2, per_env):
    _, _, _, _, _, _, got = go2
    d = per_env[:, 0].reshape(len(per_env), 20, SLOTS)
    ccd = d[..., :K]
    # the vertex states: the box's corner touches several prisms at once
    assert ((ccd[12:14, 0] < 0).sum(-1) >= 3).all(), ccd[12:14, 0]
    # the border states: masked prisms drop every CCD slot of a pair, and
    # the picks past the unmasked prisms are empty
    assert (ccd[14:] == DROPPED).all()
    n = per_env[14:, 4:7].reshape(2, 3, 20, SLOTS)[..., :K]
    assert (n == np.array([0.0, 0.0, 1.0])[None, :, None, None]).all(0).any()
    assert (d[14:, :, K:] < 0).any(), 'no corner sample touches at the border'
    np.testing.assert_array_equal(got[:, 0] == DROPPED, per_env[:, 0] == DROPPED)
