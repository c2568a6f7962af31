"""The port's sensors (sensors/*.py) and the dynamics they read against the
JAX package's, in f64, each sensor driven by hand on seeded states as the
reference's own tests/test_sensors.py drives its sensors.

* `body_velocities` and `body_accelerations` (with and without the
  gravity offset) on aliengo, 1e-9.
* HeightMap: the grid offsets for even and odd sizes (exactly),
  `grid_points` at seeded yaws, `update` on aliengo/perlin with an env
  whose rays all miss (its cells keep their last points), `get_height`.
* IMU: the true readings with the noise at 0, 1e-9; the noise and bias
  arithmetic with JAX's own draws (the reference's 5-way key split) fed to
  both sides; a noisy IMU without a generator raises.
* Camera: the intrinsics, the frame and `render` at 16 x 12 on aliengo/flat
  and aliengo/perlin (depth, plane depth and point cloud 1e-9, seg ids
  exactly), and the fps gate over 40 steps with two env clocks.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu import sensors as jsen
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import dynamics as jdyn
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu_torch import sensors as psen
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import dynamics as pdyn
from gym_quadruped_tpu_torch.physics import kinematics as pkin
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
    """scene -> (reference aliengo model, port model in f64), made once."""
    made = {}

    def get(scene):
        if scene not in made:
            jm = jload('aliengo', scene)
            made[scene] = jm, to_device(
                from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                'cpu', torch.float64)
        return made[scene]
    return get


def _states(jm, B, seed):
    """qpos, qvel, qacc of B seeded states: the keyframe moved and turned,
    joints +-0.3 rad off, random velocities and accelerations."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, :2] += rng.uniform(-2.0, 2.0, (B, 2))
    quat = rng.randn(B, 4)
    quat[:, 0] += 4.0                        # near upright, any yaw below
    yaw = rng.uniform(-np.pi, np.pi, B)
    quat = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1) + 0.1 * quat / 4
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, jm.nq - 7))
    return qpos, rng.randn(B, jm.nv), 3.0 * rng.randn(B, jm.nv)


def _fwd_ref(jm, q, qacc):
    """The reference's Forward fields a sensor reads, at one state."""
    kin = jkin.fk(jm, q)
    return SimpleNamespace(kin=kin, cdof=jkin.cdof(jm, kin), qacc=qacc)


def _fwd_port(dm, qpos, qacc):
    kin = pkin.fk(dm, qpos)
    return SimpleNamespace(kin=kin, cdof=pkin.cdof(dm, kin), qacc=qacc)


def _tensors(*xs):
    return [torch.as_tensor(x) for x in xs]


def test_body_velocities_and_accelerations(models):
    jm, dm = models('flat')
    qpos, qvel, qacc = _states(jm, 4, seed=1)

    def ref(q, v, a):
        f = _fwd_ref(jm, q, a)
        return (jdyn.body_velocities(jm, f.kin, v, f.cdof),
                jdyn.body_accelerations(jm, f.kin, v, a, f.cdof),
                jdyn.body_accelerations(jm, f.kin, v, a, f.cdof, gravity_offset=False))

    want = jax.jit(jax.vmap(ref))(qpos, qvel, qacc)
    q, v, a = _tensors(qpos, qvel, qacc)
    f = _fwd_port(dm, q, a)
    got = (pdyn.body_velocities(dm, f.kin, v, f.cdof),
           pdyn.body_accelerations(dm, f.kin, v, a, f.cdof),
           pdyn.body_accelerations(dm, f.kin, v, a, f.cdof, gravity_offset=False))
    for name, g, w in zip(('velocities', 'accelerations', 'accelerations without g'), got, want):
        assert g.shape == (4, jm.nbody, 6)
        _close(g, np.asarray(w), 1e-9, name)


@pytest.mark.parametrize('rows, cols, dx, dy', [(10, 10, 0.1, 0.1), (5, 7, 0.08, 0.12),
                                                (4, 3, 0.1, 0.05)])
def test_heightmap_grid(models, rows, cols, dx, dy):
    jm, dm = models('flat')
    kw = dict(num_rows=rows, num_cols=cols, dist_x=dx, dist_y=dy)
    ref, port = jsen.HeightMap(jm, **kw), psen.HeightMap(dm, **kw)
    assert np.array_equal(port._offsets, ref._offsets)
    assert port.available_observations() == ref.available_observations()
    for name in ref.available_observations():
        assert port.observation_dim(name) == ref.observation_dim(name)
    qpos = _states(jm, 5, seed=2)[0]
    _close(port.grid_points(torch.as_tensor(qpos)),
           np.asarray(jax.jit(jax.vmap(ref.grid_points))(qpos)), 1e-9, 'grid_points')


def test_heightmap_update_keeps_missed_cells(models):
    """aliengo/perlin: envs over the terrain, one far below it (every ray
    misses, its cells keep their last points), from seeded last points."""
    jm, dm = models('perlin')
    ref, port = jsen.HeightMap(jm), psen.HeightMap(dm)
    B = 3
    qpos = _states(jm, B, seed=3)[0]
    qpos[:, 2] += 0.8
    qpos[2, 2] = -5.0
    last = np.random.RandomState(4).randn(B, 10, 10, 3)
    want = jax.jit(jax.vmap(lambda p, q: ref.update(jsen.HeightMapState(points=p), q)))(last, qpos)
    got = port.update(psen.HeightMapState(points=torch.as_tensor(last)), torch.as_tensor(qpos))
    _close(got.points, np.asarray(want.points), 1e-9, 'points')
    assert np.array_equal(got.points[2].numpy(), last[2])
    assert not np.isclose(got.points[:2].numpy(), last[:2]).any()
    for name in ('height_map', 'height_map_z'):
        _close(port.get_observation(name, got),
               np.asarray(jax.vmap(lambda s: ref.get_observation(name, s))(want)), 1e-9, name)
    target = qpos[:, :3] + np.random.RandomState(5).uniform(-0.4, 0.4, (B, 3))
    _close(port.get_height(got, torch.as_tensor(target)),
           np.asarray(jax.vmap(ref.get_height)(want, target)), 1e-12, 'get_height')


IMU_NOISE = dict(accel_noise=0.3, gyro_noise=0.2, accel_bias_rate=0.05, gyro_bias_rate=0.07)
IMU_QUIET = dict(accel_noise=0.0, gyro_noise=0.0, accel_bias_rate=0.0, gyro_bias_rate=0.0)


def _imu_ref_step(jm, imu):
    return jax.jit(jax.vmap(lambda ss, q, v, a: imu.step(ss, q, v, _fwd_ref(jm, q, a))))


def test_imu_truth(models):
    """With the noise at 0: the site's acceleration (gravity offset) and
    angular velocity in the site frame; +9.81 z at rest, level."""
    jm, dm = models('flat')
    ref, port = jsen.IMU(jm, **IMU_QUIET), psen.IMU(dm, **IMU_QUIET)
    assert port.site_id == ref.site_id >= 0 and port.body_id == ref.body_id
    B = 4
    qpos, qvel, qacc = _states(jm, B, seed=6)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    ss = jax.vmap(lambda k: ref.init(k, jnp.float64))(keys)
    want = _imu_ref_step(jm, ref)(ss, qpos, qvel, qacc)
    q, v, a = _tensors(qpos, qvel, qacc)
    ss0 = port.init(None, B)
    assert bool(ss0.acc.isnan().all() and ss0.gyro.isnan().all() and (ss0.acc_bias == 0).all())
    got = port.step(ss0, q, v, _fwd_port(dm, q, a))      # no noise: no generator needed
    for f in dataclasses.fields(got):
        _close(getattr(got, f.name), np.asarray(getattr(want, f.name)), 1e-9, f.name)
    key, zero = torch.as_tensor(jm.key_qpos[0][None]), torch.zeros(1, jm.nv, dtype=torch.float64)
    rest = port.step(port.init(None, 1), key, zero, _fwd_port(dm, key, zero))
    _close(rest.acc, np.array([[0.0, 0.0, 9.81]]), 1e-9, 'at rest')


def test_imu_noise_with_reference_draws(models):
    """The noise and bias steps from JAX's own draws (the reference's
    `split(rng, 5)`, one standard normal (3,) per key) fed to the port's
    `measure`, over two readings."""
    jm, dm = models('flat')
    ref, port = jsen.IMU(jm, **IMU_NOISE), psen.IMU(dm, **IMU_NOISE)
    B = 3
    qpos, qvel, qacc = _states(jm, B, seed=7)
    ss = jax.vmap(lambda k: ref.init(k, jnp.float64))(jax.random.split(jax.random.PRNGKey(8), B))
    q, v, a = _tensors(qpos, qvel, qacc)
    acc, gyro = port.truth(v, _fwd_port(dm, q, a))
    got = port.init(None, B)
    step = _imu_ref_step(jm, ref)
    draws = jax.jit(jax.vmap(lambda k: jnp.stack([jax.random.normal(kk, (3,), jnp.float64)
                                                  for kk in jax.random.split(k, 5)[:4]])))
    for reading in range(2):
        z = torch.as_tensor(np.array(draws(ss.rng)))
        ss = step(ss, qpos, qvel, qacc)
        got = port.measure(got, acc, gyro, z)
        for f in dataclasses.fields(got):
            _close(getattr(got, f.name), np.asarray(getattr(ss, f.name)), 1e-12,
                   f'{f.name} reading {reading}')
    assert bool((got.acc_bias != 0).all())
    with pytest.raises(ValueError, match='generator'):
        port.step(got, q, v, _fwd_port(dm, q, a))
    noisy = port.step(got, q, v, _fwd_port(dm, q, a), torch.Generator().manual_seed(9))
    assert bool((noisy.acc - acc - noisy.acc_bias - noisy.acc_noise).abs().max() < 1e-12)


def _camera_pose(jm, B, seed):
    qpos = _states(jm, B, seed)[0]
    qpos[:, 2] += 0.3
    return qpos


@pytest.mark.parametrize('scene', ['flat', 'perlin'])
def test_camera_render(models, scene):
    jm, dm = models(scene)
    ref = jsen.Camera(jm, 16, 12, cam_name='robotcam')
    port = psen.Camera(dm, 16, 12, cam_name='robotcam')
    assert port.id == ref.id and port.fov == ref.fov
    assert np.array_equal(port.intrinsic_mat, ref.intrinsic_mat)
    assert np.array_equal(port._pixel_dirs(), ref._pixel_dirs(np.float64))
    B = 3
    qpos = _camera_pose(jm, B, seed=10)
    kin = pkin.fk(dm, torch.as_tensor(qpos))
    R, p = port.frame_config(kin)
    R_ref, p_ref = jax.jit(jax.vmap(lambda q: ref.frame_config(jkin.fk(jm, q))))(qpos)
    _close(R, np.asarray(R_ref), 1e-12, 'frame R')
    _close(p, np.asarray(p_ref), 1e-12, 'frame p')
    want = [np.asarray(x) for x in jax.jit(jax.vmap(ref.shoot))(qpos)]
    got = port.render(kin)
    assert [tuple(x.shape) for x in got] == [(B, 12, 16)] * 3 + [(B, 192, 3)]
    for name, g, w in zip(('depth', 'plane depth', 'seg', 'point cloud'), got, want):
        if name == 'seg':
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w, err_msg=scene)
        else:
            _close(g, w, 1e-9, f'{scene} {name}')
    seg = want[2]
    assert (seg == -1).any() and (seg >= 0).any(), 'the render shows neither sky nor ground'
    if scene == 'perlin':
        assert (seg == 1).any(), 'no pixel hit the heightfield'
    for name, g in zip(('depth_image', 'seg_image', 'point_cloud'),
                       (port.depth_image(kin), port.seg_image(kin), port.point_cloud(kin))):
        assert torch.equal(g, got[{'depth_image': 0, 'seg_image': 2, 'point_cloud': 3}[name]])


def test_camera_fps_gate(models):
    """Camera.step with auto_render over 40 steps of a moving robot, two envs
    whose clocks differ (as after a quarantine reset): the same renders and
    times as the reference's, and the renders its rule picks."""
    jm, dm = models('flat')
    kw = dict(width=8, height=6, fps=60.0, cam_name='robotcam', auto_render=True)
    ref, port = jsen.Camera(jm, **kw), psen.Camera(dm, **kw)
    B = 2
    ss_ref = jax.vmap(lambda k: ref.init(k, jnp.float64))(jax.random.split(jax.random.PRNGKey(0), B))
    ss_ref = dataclasses.replace(ss_ref, time=jnp.asarray([0.0, 0.007]))
    ss = port.init(None, B)
    ss.time = torch.tensor([0.0, 0.007], dtype=torch.float64)
    step_ref = jax.jit(jax.vmap(lambda s, q: ref.step(s, q, None, SimpleNamespace(
        kin=jkin.fk(jm, q)))))
    base = _camera_pose(jm, B, seed=11)
    renders = np.zeros(B, int)
    for t in range(40):
        qpos = base.copy()
        qpos[:, 0] += 0.01 * t
        last = ss.last_time.clone()
        ss_ref = step_ref(ss_ref, qpos)
        ss = port.step(ss, torch.as_tensor(qpos), None,
                       SimpleNamespace(kin=pkin.fk(dm, torch.as_tensor(qpos))))
        np.testing.assert_array_equal(ss.last_time.numpy(), np.asarray(ss_ref.last_time))
        np.testing.assert_array_equal(ss.time.numpy(), np.asarray(ss_ref.time))
        np.testing.assert_array_equal(ss.seg.numpy(), np.asarray(ss_ref.seg))
        _close(ss.depth, np.asarray(ss_ref.depth), 1e-9, f'depth step {t}')
        renders += (ss.last_time != last).numpy()
    # the rule on the host: render when 1/fps has passed since the last one
    expect = np.zeros(B, int)
    for b, t0 in enumerate((0.0, 0.007)):
        clock, last = t0, -1e9
        for _ in range(40):
            clock += jm.timestep
            if clock - last >= 1.0 / 60.0 - 1e-9:
                expect[b] += 1
                last = clock
    np.testing.assert_array_equal(renders, expect)
    assert (expect > 1).all()
    obs = port.get_observation('seg_image', ss)
    assert obs.shape == (B, 48) and obs.dtype == torch.float64
