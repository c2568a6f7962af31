"""The port's heightfield narrow phase, part 3: the per-prism CCD through
the cylinder group (`_hfield_cylinder`: the CCD's 8 slots and the 4
deepest of its end spheres' 16) on b2/perlin (4 hip cylinders, a 3 x 3-cell
footprint: 18 prisms per pair), in f64 against the JAX package's per-env
`collide` and its batched twin, both run on the cylinder group alone. Kept
apart from the box group's file so that their reference programs (about a
minute of XLA compile each) build in parallel.

States: 8 seeded tumbled states, the base raised by the terrain's height
under the keyframe (the hips grind into it); 4 shallow states, the lowest
rim point 3 mm into the terrain; 2 at the grid's border (masked prisms:
the CCD slots drop, empty picks). Bars and exceptions as in
`test_torch_collision_hfield_box.py`; a cylinder's support tie is a normal
perpendicular to its axis (the sign of that rounding picks the cap).
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
from gym_quadruped_tpu_torch.physics import collision as pcol
from test_torch_collision_go2 import DROPPED, _group_slots, _port_feat, _port_model, _poses, \
    _states
from test_torch_collision_hfield_box import SLOTS, K, border_states, check_convex, \
    lowest_points, subset


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rim_points(radius, halflen, n=16):
    """p (B, G, 3), R (B, G, 3, 3) -> (B, G, 2 n, 3): n points on each cap's
    rim."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(t), np.sin(t), np.zeros(n)], -1)               # (n, 3)
    local = np.concatenate([ring[None] * radius[:, None, None] + [0, 0, 1] * halflen[:, None, None],
                            ring[None] * radius[:, None, None] - [0, 0, 1] * halflen[:, None, None]],
                           1)                                               # (G, 2n, 3)
    return lambda p, R: p[:, :, None] + np.einsum('bgij,gkj->bgki', R, local)


@pytest.fixture(scope='module')
def b2():
    jm = jload('b2', 'perlin')
    dm = _port_model(jm)
    sub, geoms = subset(jm, 'hfield-cylinder')
    size = np.asarray(jm.geom_size)[geoms]
    seed = zlib.crc32(b'b2/perlin/hfield-cylinder')
    lift = float(jcol.hfield_height(jm, 0.0, 0.0, jnp.float64)) - float(jm.key_qpos[0, 2])
    tumbled = _states(jm, 8, seed, 0.7)
    tumbled[:, 2] += lift + 0.1
    shallow = _states(jm, 4, seed + 1, 0.3)
    xp, xm = _poses(jm, shallow)
    shallow[:, 2] -= lowest_points(jm, xp, xm, geoms, rim_points(size[:, 0], size[:, 1])) + 0.003
    border = border_states(jm, 2, seed + 2)
    border[:, 2] += float(jm.key_qpos[0, 2]) - 0.27
    qpos = np.concatenate([tumbled, shallow, border])
    xpos, xmat = _poses(jm, qpos)
    got = _port_feat(dm, xpos, xmat)[:, :, _group_slots(dm.m)['hfield-cylinder']]
    return jm, dm, sub, geoms, xpos, xmat, got


def test_layout_and_span(b2):
    jm, dm, _, geoms, _, _, got = b2
    assert pcol.hfield_span(dm.m, geoms) == jcol.hfield_span(jm, geoms) == 3
    assert got.shape[2] == 4 * SLOTS
    assert pcol.total_contact_slots(dm.m) == jcol.total_contact_slots(jm) == 1354


@pytest.fixture(scope='module')
def per_env(b2):
    _, _, sub, _, xpos, xmat, _ = b2
    return np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
        sub, jbt._KinView(xp, xm)).feat))(xpos, xmat))


@pytest.fixture(scope='module')
def batched(b2):
    _, _, sub, _, xpos, xmat, _ = b2
    return np.asarray(jax.jit(lambda xp, xm: jbt.collide_bt(sub, xp, xm))(
        xpos, xmat)).transpose(2, 0, 1)


@pytest.mark.parametrize('path', ['per-env', 'bt'])
def test_matches_reference(b2, per_env, batched, path):
    _, _, _, geoms, _, xmat, got = b2
    ref = per_env if path == 'per-env' else batched
    counts = check_convex(got, ref, xmat[:, geoms], f'b2/perlin hfield-cylinder ({path})', [2])
    assert counts['near'] > 50
    assert counts['support ties'] <= max(2, 0.02 * counts['near']), counts


def test_special_states_reach_their_cases(b2, per_env):
    _, _, _, _, _, _, got = b2
    d = per_env[:, 0].reshape(len(per_env), 4, SLOTS)
    # the CCD's contacts and the end spheres' both touch in these states
    assert (d[:12, :, :K] < 0).any() and (d[:12, :, K:] < 0).any()
    # the border states: the CCD slots drop on both sides
    assert (d[12:, :, :K] == DROPPED).all()
    np.testing.assert_array_equal(got[:, 0] == DROPPED, per_env[:, 0] == DROPPED)
