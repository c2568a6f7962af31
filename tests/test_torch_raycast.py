"""The port's ray casting (physics/raycast.py) against the JAX package's, in f64.

* The march's 64 fractions bit for bit against the reference's
  `jnp.linspace(0, 1, 64)`, in f64 and cast to f32.
* Every primitive (plane, box, sphere, capsule; the cylinder is cast as a
  capsule) on seeded rays and seeded geom poses, per env: t to 1e-9, the
  same rays hit.
* The heightfield (aliengo/perlin's) on vertical rays (the bilinear
  surface) and oblique ones (the march and its bisection): t to 1e-9; the
  vertical rays' answer without the march is the same.
* `raycast` on aliengo/perlin (plane and heightfield, the robot's geoms
  posed by FK) and go2/stairs (plane and 50 boxes), with and without the
  robot: t to 1e-9, geom ids exactly, misses -1; in env chunks of any size
  the same result.
* `raycast_down` on both scenes.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import raycast as jray
from gym_quadruped_tpu.physics.kinematics import fk as jfk
from gym_quadruped_tpu_torch.models.model import GEOM_BOX, GEOM_HFIELD, from_arrays, to_device
from gym_quadruped_tpu_torch.physics import raycast as pray
from gym_quadruped_tpu_torch.physics.kinematics import fk as pfk
from test_torch_step import _close


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def models():
    """(robot, scene) -> (reference model, port model in f64), made once."""
    made = {}

    def get(robot, scene):
        if (robot, scene) not in made:
            jm = jload(robot, scene)
            made[robot, scene] = jm, to_device(
                from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                'cpu', torch.float64)
        return made[robot, scene]
    return get


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _quat_mats(rng, n):
    return np.stack([jray._quat_mat_np(q) for q in _unit(rng.randn(n, 4))])


def test_march_fractions_match_linspace():
    ref = np.asarray(jnp.linspace(0.0, 1.0, pray.MARCH_SAMPLES))
    assert ref.dtype == np.float64
    assert np.array_equal(pray.MARCH_FRACTIONS.view(np.int64), ref.view(np.int64))
    ref32 = np.asarray(jnp.linspace(0.0, 1.0, pray.MARCH_SAMPLES).astype(jnp.float32))
    got32 = torch.as_tensor(pray.MARCH_FRACTIONS).float().numpy()
    assert np.array_equal(got32.view(np.int32), ref32.view(np.int32))
    # why the fractions are a constant: torch.linspace rounds some apart
    assert (torch.linspace(0, 1, pray.MARCH_SAMPLES, dtype=torch.float64).numpy() != ref).any()


def _rays(rng, B, N, centres):
    """B x N rays: origins within 2 m of the centres (B, G, 3), half of
    the directions aimed at a random centre, half random."""
    o = centres.mean(1, keepdims=True) + rng.uniform(-2.0, 2.0, (B, N, 3))
    aim = centres[np.arange(B)[:, None], rng.randint(0, centres.shape[1], (B, N))]
    aim = aim + 0.05 * rng.randn(B, N, 3)
    d = np.where(np.arange(N)[None, :, None] % 2 == 0, aim - o, rng.randn(B, N, 3))
    return o, _unit(d)


@pytest.mark.parametrize('prim', ['plane', 'box', 'sphere', 'capsule'])
def test_primitive_matches_reference(prim):
    """Per env, G geoms of one type posed per env (as the robot's are) against
    N rays over (B, G, N), the port's broadcasting path."""
    rng = np.random.RandomState({'plane': 1, 'box': 2, 'sphere': 3, 'capsule': 4}[prim])
    B, G, N = 2, 3, 64
    gpos = rng.uniform(-1.0, 1.0, (B, G, 3))
    gmat = _quat_mats(rng, B * G).reshape(B, G, 3, 3)
    size = rng.uniform(0.05, 0.5, (G, 3))
    o, d = _rays(rng, B, N, gpos)
    port = getattr(pray, f'ray_{prim}')
    got = port(*(torch.as_tensor(x) for x in (gpos[:, :, None], gmat[:, :, None], size[:, None],
                                              o[:, None], d[:, None]))).numpy()
    ref_fn = jax.jit(jax.vmap(getattr(jray, f'ray_{prim}'), (None, None, None, 0, 0)))
    ref = np.stack([np.stack([np.asarray(ref_fn(gpos[b, g], gmat[b, g], size[g], o[b], d[b]))
                              for g in range(G)]) for b in range(B)])
    hit = ref < pray._BIG
    np.testing.assert_array_equal(got < pray._BIG, hit, err_msg=f'{prim} hits')
    assert 0.1 < hit.mean() < 0.95, hit.mean()
    _close(got[hit], ref[hit], 1e-9, prim)
    np.testing.assert_array_equal(got[~hit], ref[~hit])


def _hfield(jm):
    h = int(np.flatnonzero(np.asarray(jm.geom_type) == GEOM_HFIELD)[0])
    return np.asarray(jm.geom_pos[h]), jray._quat_mat_np(jm.geom_quat[h])


def test_ray_hfield_matches_reference(models):
    """aliengo/perlin's heightfield: vertical rays from above (some off the
    field, some below the surface: misses), oblique rays down onto it and up
    away from it."""
    jm, dm = models('aliengo', 'perlin')
    gpos, gmat = _hfield(jm)
    sx, sy = float(jm.hfield_size[0]), float(jm.hfield_size[1])
    rng = np.random.RandomState(5)
    N = 96
    o = np.stack([rng.uniform(-1.1 * sx, 1.1 * sx, N), rng.uniform(-1.1 * sy, 1.1 * sy, N),
                  rng.uniform(-0.2, 2.0, N)], -1)
    vertical = np.tile([0.0, 0.0, -1.0], (N, 1))
    oblique = _unit(np.stack([rng.randn(N), rng.randn(N), rng.uniform(-1.0, 0.3, N)], -1))
    ref_fn = jax.jit(jax.vmap(lambda o_, d_: jray.ray_hfield(jm, gpos, gmat, o_, d_)))
    for name, d in (('vertical', vertical), ('oblique', oblique)):
        args = [torch.as_tensor(x) for x in (gpos, gmat, o, d)]
        got = pray.ray_hfield(dm, *args).numpy()
        ref = np.asarray(ref_fn(o, d))
        hit = ref < pray._BIG
        np.testing.assert_array_equal(got < pray._BIG, hit, err_msg=f'{name} hits')
        assert 0.2 < hit.mean() < 0.95, (name, hit.mean())
        _close(got[hit], ref[hit], 1e-9, name)
        if name == 'vertical':
            assert np.array_equal(pray.ray_hfield(dm, *args, march=False).numpy(), got)


def _scene_rays(rng, B, N, kin_xpos):
    """Rays of B envs: origins 1-2 m above the base within 1 m, half aimed
    at the robot's geoms, a quarter straight down, a quarter random (some
    upward: misses)."""
    base = kin_xpos[:, 1]
    o = base[:, None] + np.concatenate([rng.uniform(-1.0, 1.0, (B, N, 2)),
                                        rng.uniform(1.0, 2.0, (B, N, 1))], -1)
    aim = kin_xpos[np.arange(B)[:, None], rng.randint(1, kin_xpos.shape[1], (B, N))]
    d = aim + 0.05 * rng.randn(B, N, 3) - o
    k = np.arange(N)
    d[:, k % 4 == 1] = [0.0, 0.0, -1.0]
    d[:, k % 4 == 3] = rng.randn(B, int((k % 4 == 3).sum()), 3)
    return o, _unit(d)


def _states(jm, B, seed):
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, :2] += rng.uniform(-1.0, 1.0, (B, 2))
    qpos[:, 2] += 0.3
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, jm.nq - 7))
    return qpos


def _ref_raycast(jm, robot):
    if robot:
        return jax.jit(jax.vmap(lambda o, d, xp, xm: jray.raycast(
            jm, o, d, kin=SimpleNamespace(geom_xpos=xp, geom_xmat=xm))))
    return jax.jit(jax.vmap(lambda o, d: jray.raycast(jm, o, d)))


@pytest.mark.parametrize('robot, scene', [('aliengo', 'perlin'), ('go2', 'stairs')])
def test_raycast_matches_reference(models, robot, scene):
    jm, dm = models(robot, scene)
    B, N = 3, 64
    qpos = _states(jm, B, seed=6)
    if scene == 'stairs':   # the robot over the steps
        qpos[:, 0] += np.asarray(jm.geom_pos)[np.asarray(jm.geom_type) == GEOM_BOX, 0].mean()
    kin = pfk(dm, torch.as_tensor(qpos))
    jkin = jax.jit(jax.vmap(lambda q: jfk(jm, q)))(qpos)
    o, d = _scene_rays(np.random.RandomState(7), B, N, np.asarray(jkin.xpos))
    world = set(pray.world_geoms(dm.m))
    for with_robot in (True, False):
        args = (jkin.geom_xpos, jkin.geom_xmat) if with_robot else ()
        rt, rid = (np.asarray(x) for x in _ref_raycast(jm, with_robot)(o, d, *args))
        t, gid = pray.raycast(dm, torch.as_tensor(o), torch.as_tensor(d),
                              kin=kin if with_robot else None)
        np.testing.assert_array_equal(gid.numpy(), rid, err_msg=f'{scene} robot={with_robot}')
        assert gid.dtype == torch.int32
        _close(t.numpy(), rt, 1e-9, f'{scene} t robot={with_robot}')
        assert ((rid == -1) == (rt == -1)).all() and (rid == -1).any()
        hit_world = np.isin(rid, list(world))
        assert hit_world.any()
        if with_robot:
            assert (~hit_world & (rid >= 0)).any(), 'no ray met the robot'
        if scene == 'stairs':
            assert len(set(rid[hit_world].tolist())) > 3, 'the rays met few steps'
        else:
            assert (rid == 1).any() and (rid == 0).any(), 'plane and heightfield both met'


def test_raycast_chunks(models, monkeypatch):
    """The envs cast in chunks of any size give the same result."""
    jm, dm = models('aliengo', 'perlin')
    B, N = 5, 32
    qpos = torch.as_tensor(_states(jm, B, seed=8))
    kin = pfk(dm, qpos)
    o, d = _scene_rays(np.random.RandomState(9), B, N, kin.xpos.numpy())
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    whole = pray.raycast(dm, o, d, kin=kin)
    for per_chunk in (1, 2):
        monkeypatch.setattr(pray, 'RAY_CHUNK', per_chunk * N * pray.MARCH_SAMPLES)
        part = pray.raycast(dm, o, d, kin=kin)
        assert all(torch.equal(a, b) for a, b in zip(whole, part)), per_chunk


@pytest.mark.parametrize('robot, scene', [('aliengo', 'perlin'), ('go2', 'stairs')])
def test_raycast_down_matches_reference(models, robot, scene):
    """Straight-down rays over the scene (the heightmap's): without the march,
    the same as the reference's and as the port's marching path."""
    jm, dm = models(robot, scene)
    rng = np.random.RandomState(10)
    B, N = 2, 100
    lo, hi = (-1.1 * float(jm.hfield_size[0]), 1.1 * float(jm.hfield_size[0])) \
        if scene == 'perlin' else (-1.0, 6.0)
    o = np.stack([rng.uniform(lo, hi, (B, N)), rng.uniform(lo, hi, (B, N)),
                  rng.uniform(-0.1, 2.0, (B, N))], -1)
    ref = np.asarray(jax.jit(jax.vmap(lambda o_: jray.raycast_down(jm, o_)))(o))
    got = pray.raycast_down(dm, torch.as_tensor(o))
    _close(got.numpy(), ref, 1e-9, f'{scene} raycast_down')
    assert (ref == -1).any() and (ref > 0).any()
    marched = pray._cast(dm, torch.as_tensor(o), torch.tensor([0.0, 0, -1], dtype=torch.float64).expand(B, N, 3),
                         None)[0]
    assert torch.equal(marched, got)
