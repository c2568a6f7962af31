"""The port's MPC building blocks against the JAX package's, in f64.

Inputs are made with numpy from a seed and fed to both packages; each
reference function runs under `jax.vmap` over the envs the port batches.

* The controller's dataclasses keep the reference's field names and
  defaults (`dataclasses.asdict`), and `CentroidalParams.from_model` and the
  standing height match on every compiled flat robot, to 1e-12.
* gait: every gait of GAITS and an explicit offsets/duty config; schedules
  equal bit for bit, phases and swing progress to 1e-12.
* centroidal: rz, srb_dynamics, build_horizon, state_from_env and
  reference_trajectory to 1e-12 of 1 + max|reference|.
* qp: condense to 1e-10; project_pyramid to 1e-12 on forces inside the
  cone, in its polar cone, on each wedge's edge, on swing knots and past
  fz_max; spd_inverse to 1e-9 on envs whose diagonals and swing masks
  differ (its reductions are each env's own); admm_solve cold (30
  iterations) and warm (10, from a given (U, z, y)) to 1e-9 of 1 + max|U|;
  the ADMM against scipy's SLSQP on the same QP within 1e-3 (the
  reference's own check, tests/test_mpc.py); the constraint-matrix form;
  in f32 the port's Newton-Schulz residuals no larger than the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu import mpc as jmpc
from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.mpc import centroidal as jsrb
from gym_quadruped_tpu.mpc import gait as jgait
from gym_quadruped_tpu.mpc import qp as jqp
from gym_quadruped_tpu_torch import mpc as pmpc
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import centroidal as psrb
from gym_quadruped_tpu_torch.mpc import gait as pgait
from gym_quadruped_tpu_torch.mpc import qp as pqp
from test_mpc import _scipy_reference_qp
from test_torch_step import _close

FLAT_ROBOTS = ('aliengo', 'b2', 'go1', 'go2', 'hyqreal1', 'hyqreal2', 'mini_cheetah', 'spot')
H = 12
DT = 0.02
MU, FZ_MIN, FZ_MAX = 0.7, 0.0, 500.0


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope='module')
def go2():
    dm = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    return psrb.CentroidalParams.from_model(dm.m), jsrb.CentroidalParams.from_model(jload('go2', 'flat'))


def _states(rng, B):
    """Seeded inputs of the SRB builders: yaw, feet relative to the CoM,
    schedules, qpos/qvel, commands."""
    quat = rng.randn(B, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos = np.concatenate([rng.uniform(-1, 1, (B, 2)), rng.uniform(0.2, 0.4, (B, 1)), quat,
                           rng.uniform(-1, 1, (B, 12))], 1)
    return dict(
        yaw=rng.uniform(-np.pi, np.pi, B),
        feet=np.array([[0.19, 0.14, -0.27], [0.19, -0.14, -0.27],
                       [-0.19, 0.14, -0.27], [-0.19, -0.14, -0.27]]) + 0.03 * rng.randn(B, 4, 3),
        sched=(rng.rand(B, H, 4) < 0.6).astype(np.float64),
        qpos=qpos, qvel=rng.randn(B, 18), euler=rng.uniform(-0.3, 0.3, (B, 3)),
        ref=np.concatenate([rng.uniform(-0.5, 0.5, (B, 2)), np.zeros((B, 1))], 1),
        yaw_dot=rng.uniform(-0.5, 0.5, B))


# ---- carrying the parameters across ---------------------------------------------------

@pytest.mark.parametrize('name', ['MPCConfig', 'GaitConfig', 'MPCWeights', 'MPPIConfig'])
def test_dataclass_defaults_match(name):
    port, ref = getattr(pmpc, name), getattr(jmpc, name)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


@pytest.mark.parametrize('robot', FLAT_ROBOTS)
def test_centroidal_params_from_model(robot):
    dm = load_model(robot, 'flat', device='cpu', dtype=torch.float64)
    jm = jload(robot, 'flat')
    p, r = psrb.CentroidalParams.from_model(dm.m), jsrb.CentroidalParams.from_model(jm)
    assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(r)]
    assert (p.mu, p.fz_min, p.fz_max) == (r.mu, r.fz_min, r.fz_max)
    np.testing.assert_allclose(p.mass, r.mass, rtol=1e-12)
    _close(p.inertia_body, np.asarray(r.inertia_body), 1e-12, 'inertia_body')
    assert dm.m.base_body_id == jm.base_body_id
    assert pmpc.CentroidalMPC(dm).stand_height == jmpc.CentroidalMPC(jm).stand_height


# ---- gait ------------------------------------------------------------------------------

GAIT_CONFIGS = [(name, {}) for name in jgait.GAITS] + [
    ('trot', {'period': 0.4, 'offsets': (0.0, 0.25, 0.5, 0.75), 'duty': 0.7})]


@pytest.mark.parametrize('name,kw', GAIT_CONFIGS, ids=[c[0] + ('_explicit' if c[1] else '')
                                                        for c in GAIT_CONFIGS])
def test_gait_matches(name, kw):
    np.testing.assert_array_equal(pgait.GAITS[name][0], jgait.GAITS[name][0])
    assert pgait.GAITS[name][1] == jgait.GAITS[name][1]
    pc, jc = pgait.GaitConfig(name, **kw), jgait.GaitConfig(name, **kw)
    t = np.random.RandomState(3).uniform(0.0, 3.0, 16)
    ref_sched = jax.vmap(lambda s: jgait.contact_schedule(jc, s, H, DT))(jnp.asarray(t))
    np.testing.assert_array_equal(pgait.contact_schedule(pc, _t(t), H, DT).numpy(),
                                  np.asarray(ref_sched))
    _close(pgait.leg_phases(pc, _t(t)), np.asarray(jax.vmap(
        lambda s: jgait.leg_phases(jc, s))(jnp.asarray(t))), 1e-12, 'leg_phases')
    _close(pgait.swing_phase(pc, _t(t)), np.asarray(jax.vmap(
        lambda s: jgait.swing_phase(jc, s))(jnp.asarray(t))), 1e-12, 'swing_phase')


# ---- centroidal ------------------------------------------------------------------------

def test_centroidal_matches(go2):
    pp, jp = go2
    s = _states(np.random.RandomState(0), 6)
    _close(psrb.rz(_t(s['yaw'])), np.asarray(jax.vmap(jsrb.rz)(jnp.asarray(s['yaw']))), 1e-12, 'rz')
    A, B = psrb.srb_dynamics(pp, _t(s['yaw']), _t(s['feet']), _t(s['sched'][:, 0]), DT)
    jA, jB = jax.vmap(lambda y, f, c: jsrb.srb_dynamics(jp, y, f, c, DT))(
        jnp.asarray(s['yaw']), jnp.asarray(s['feet']), jnp.asarray(s['sched'][:, 0]))
    _close(A, np.asarray(jA), 1e-12, 'srb A')
    _close(B, np.asarray(jB), 1e-12, 'srb B')
    A, B = psrb.build_horizon(pp, _t(s['yaw']), _t(s['feet']), _t(s['sched']), DT)
    jA, jB = jax.vmap(lambda y, f, c: jsrb.build_horizon(jp, y, f, c, DT))(
        jnp.asarray(s['yaw']), jnp.asarray(s['feet']), jnp.asarray(s['sched']))
    assert A.shape == (6, H, 13, 13) and B.shape == (6, H, 13, 12)
    _close(A, np.asarray(jA), 1e-12, 'horizon A')
    _close(B, np.asarray(jB), 1e-12, 'horizon B')
    x0 = psrb.state_from_env(_t(s['qpos']), _t(s['qvel']), _t(s['euler']))
    jx0 = jax.vmap(jsrb.state_from_env)(jnp.asarray(s['qpos']), jnp.asarray(s['qvel']),
                                         jnp.asarray(s['euler']))
    _close(x0, np.asarray(jx0), 1e-12, 'state_from_env')
    xr = psrb.reference_trajectory(x0, _t(s['ref']), _t(s['yaw_dot']), 0.27, H, DT)
    jxr = jax.vmap(lambda x, r, w: jsrb.reference_trajectory(x, r, w, 0.27, H, DT))(
        jx0, jnp.asarray(s['ref']), jnp.asarray(s['yaw_dot']))
    _close(xr, np.asarray(jxr), 1e-12, 'reference_trajectory')


# ---- qp --------------------------------------------------------------------------------

def _qp_inputs(go2, B, seed):
    """Condensed QPs of seeded SRB states (the production structure)."""
    pp, _ = go2
    s = _states(np.random.RandomState(seed), B)
    A, Bm = psrb.build_horizon(pp, _t(s['yaw']), _t(s['feet']), _t(s['sched']), DT)
    x0 = psrb.state_from_env(_t(s['qpos']), _t(s['qvel']), _t(s['euler']))
    xr = psrb.reference_trajectory(x0, _t(s['ref']), _t(s['yaw_dot']), 0.27, H, DT)
    return A, Bm, x0, xr, s['sched']


def test_condense_matches(go2):
    w = pqp.MPCWeights()
    A, Bm, x0, xr, _ = _qp_inputs(go2, 4, 1)
    Hq, q = pqp.condense(A, Bm, x0, xr, w.q_diag, w.r_diag)
    jHq, jq = jax.vmap(lambda a, b, x, r: jqp.condense(a, b, x, r, w.q_diag, w.r_diag))(
        *(jnp.asarray(v.numpy()) for v in (A, Bm, x0, xr)))
    assert Hq.shape == (4, H * 12, H * 12) and q.shape == (4, H * 12)
    _close(Hq, np.asarray(jHq), 1e-10, 'Hq')
    _close(q, np.asarray(jq), 1e-10, 'q')


def _pyramid_cases(rng, B):
    """(B, H*12) forces and (B, H*4) stance with every region of the set."""
    f = np.zeros((B, H * 4, 3))
    stance = np.ones((B, H * 4))
    for b in range(B):
        for i in range(H * 4):
            kind = (i + b) % 7
            fz = rng.uniform(10, 300)
            if kind == 0:      # inside the cone
                f[b, i] = [rng.uniform(-0.6, 0.6) * fz, rng.uniform(-0.6, 0.6) * fz, fz]
            elif kind == 1:    # polar cone: projects to the origin
                f[b, i] = [rng.uniform(-0.3, 0.3) * fz, rng.uniform(-0.3, 0.3) * fz, -fz]
            elif kind == 2:    # on the x-wedge's edge
                f[b, i] = [MU * fz, rng.uniform(-0.5, 0.5) * fz, fz]
            elif kind == 3:    # on the y-wedge's edge
                f[b, i] = [rng.uniform(-0.5, 0.5) * fz, -MU * fz, fz]
            elif kind == 4:    # a swing knot
                f[b, i] = rng.uniform(-200, 200, 3)
                stance[b, i] = 0.0
            elif kind == 5:    # past fz_max
                f[b, i] = [rng.uniform(-1, 1) * 400, rng.uniform(-1, 1) * 400, FZ_MAX + fz]
            else:              # outside both wedges
                f[b, i] = rng.uniform(-300, 300, 3)
    return f.reshape(B, -1), stance


def test_project_pyramid_matches():
    v, stance = _pyramid_cases(np.random.RandomState(2), 3)
    got = pqp.project_pyramid(_t(v), _t(stance), MU, FZ_MIN, FZ_MAX)
    ref = jax.vmap(lambda a, c: jqp.project_pyramid(a, c, MU, FZ_MIN, FZ_MAX))(
        jnp.asarray(v), jnp.asarray(stance))
    _close(got, np.asarray(ref), 1e-12, 'project_pyramid')
    f = got.numpy().reshape(3, -1, 3)
    assert (np.abs(f[..., :2]) <= MU * f[..., 2:] + 1e-9).all()
    assert (f[stance == 0] == 0).all()


def _ns_systems(rng, B):
    """K with the production structure per env, each env its own scale and
    swing mask: swing rows and columns exactly (r + rho) e_i, a stiff range
    and a flat remainder."""
    n, r, rho = H * 12, 1e-5, 1e-4
    Ks, masks = [], []
    for b in range(B):
        V, _ = np.linalg.qr(rng.normal(size=(n, 36)))
        K = (V * rng.uniform(1e-3, 0.14, 36) * (1.0 + 0.5 * b)) @ V.T + (r + rho) * np.eye(n)
        swing = rng.rand(n) < (0.2 + 0.2 * b)
        K[swing, :] = 0.0
        K[:, swing] = 0.0
        K[swing, swing] = r + rho
        Ks.append(K)
        masks.append(swing)
    return np.stack(Ks), np.stack(masks)


def test_spd_inverse_matches_per_env():
    K, swing = _ns_systems(np.random.RandomState(0), 3)
    assert len({float(np.abs(k).sum(-1).max()) for k in K}) == 3   # per-env row-sum bounds differ
    X = pqp.spd_inverse(_t(K), _t(swing))
    ref = jax.vmap(jqp.spd_inverse)(jnp.asarray(K), jnp.asarray(swing))
    _close(X, np.asarray(ref), 1e-9, 'spd_inverse')
    for b in range(3):   # each env alone: its reductions are its own
        _close(pqp.spd_inverse(_t(K[b:b + 1]), _t(swing[b:b + 1]))[0], X[b].numpy(), 1e-15,
               f'env {b} alone')
    resid = np.linalg.norm(np.eye(K.shape[1]) - X.numpy() @ K, axis=(1, 2))
    assert (resid < 1e-5).all(), resid


def test_spd_inverse_f32_floor():
    """In f32, on 64 of chip_smoke.py phase 47's states (bench.py's MPC
    recipe), the port's Newton-Schulz residuals ||I - XK||_F are no larger
    than the reference's own f32 iteration's on the same K, and within
    phase 47's bars (p99 1e-2, every env 3e-2). In f64 both converge. Run
    with -s, it prints both floors."""
    B = 64
    dm = load_model('go2', 'flat', device='cpu', dtype=torch.float32)
    m = dm.m
    mpc = pmpc.CentroidalMPC(dm, pmpc.MPCConfig(gait=pmpc.GaitConfig('trot')))
    gen = torch.Generator().manual_seed(0)
    qpos = torch.as_tensor(m.key_qpos[0], dtype=torch.float32).repeat(B, 1)
    qpos = qpos + 0.01 * torch.randn(B, m.nq, generator=gen)
    feet = torch.tensor([[0.19, 0.14, 0.02], [0.19, -0.14, 0.02],
                         [-0.19, 0.14, 0.02], [-0.19, -0.14, 0.02]]).expand(B, 4, 3)
    Hq, _, sched = mpc.condensed_qp(qpos, 0.1 * torch.randn(B, m.nv, generator=gen), feet,
                                    torch.rand(B, generator=gen),
                                    torch.tensor([0.4, 0.0, 0.0]).expand(B, 3), torch.zeros(B))
    n = Hq.shape[1]
    K = Hq + 1e-4 * torch.eye(n)
    swing = pqp.swing_components(sched)
    K64 = K.double().numpy()
    resid = lambda X: np.linalg.norm(np.eye(n) - np.asarray(X, np.float64) @ K64, axis=(1, 2))
    port = resid(pqp.spd_inverse(K, swing).numpy())
    ref = resid(jax.vmap(jqp.spd_inverse)(jnp.asarray(K.numpy(), jnp.float32), jnp.asarray(swing.numpy())))
    q = lambda r: (f'median {np.median(r):.3e}, p99 {np.quantile(r, 0.99):.3e}, '
                   f'max {r.max():.3e}')
    print(f'Newton-Schulz f32 residual on {B} states: port {q(port)}; reference {q(ref)}')
    assert np.quantile(port, 0.99) <= 1e-2 and port.max() <= 3e-2, q(port)
    assert np.median(port) <= np.median(ref) and port.max() <= ref.max(), (port.max(), ref.max())
    assert resid(pqp.spd_inverse(K.double(), swing).numpy()).max() < 1e-8


@pytest.mark.parametrize('warm', [False, True], ids=['cold30', 'warm10'])
def test_admm_solve_matches(go2, warm):
    w = pqp.MPCWeights()
    A, Bm, x0, xr, sched = _qp_inputs(go2, 3, 4)
    Hq, q = pqp.condense(A, Bm, x0, xr, w.q_diag, w.r_diag)
    rng = np.random.RandomState(5)
    start = tuple(rng.uniform(-50, 50, (3, H * 12)) for _ in range(3)) if warm else None
    iters = 10 if warm else 30
    U, (Uw, z, y) = pqp.admm_solve(Hq, q, _t(sched), MU, FZ_MIN, FZ_MAX, iterations=iters,
                                   warmstart=None if start is None else tuple(map(_t, start)))
    ref = jax.vmap(lambda h, g, s, ws: jqp.admm_solve(h, g, s, MU, FZ_MIN, FZ_MAX,
                                                      iterations=iters, warmstart=ws))(
        jnp.asarray(Hq.numpy()), jnp.asarray(q.numpy()), jnp.asarray(sched),
        None if start is None else tuple(map(jnp.asarray, start)))
    scale = 1e-9 * (1 + np.abs(np.asarray(ref[0])).max())
    for got, want, name in zip((U, Uw, z, y), (ref[0], *ref[1]), ('U', 'warm U', 'z', 'y')):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=scale, err_msg=name)


def test_admm_matches_scipy():
    """The reference's independent check, run on the port: a random strongly
    convex QP with friction-pyramid constraints, ADMM within 1e-3 of SLSQP."""
    rng = np.random.RandomState(0)
    n = 24
    A = rng.randn(n, n)
    Hm = A @ A.T + 5.0 * np.eye(n)
    q = 10.0 * rng.randn(n)
    sched = torch.ones(1, 2, 4, dtype=torch.float64)
    U, _ = pqp.admm_solve(_t(Hm)[None], _t(q)[None], sched, 0.7, 0.0, 100.0, iterations=4000,
                          rho=1.0)
    G = pqp.pyramid_constraints(2, mu=0.7).numpy()
    l, u = pqp.pyramid_bounds(sched[0], 0.0, 100.0)
    x_ref = _scipy_reference_qp(Hm, q, G, l.numpy(), u.numpy())
    err = np.max(np.abs(U[0].numpy() - x_ref)) / (1 + np.max(np.abs(x_ref)))
    assert err < 1e-3, f'ADMM vs scipy mismatch: {err:.2e}'


def test_pyramid_constraints_match():
    sched = (np.random.RandomState(6).rand(3, 4) < 0.5).astype(np.float64)
    np.testing.assert_array_equal(pqp.pyramid_constraints(3, 0.6).numpy(),
                                  np.asarray(jqp.pyramid_constraints(3, 0.6, jnp.float64)))
    for got, want in zip(pqp.pyramid_bounds(_t(sched), 5.0, 300.0),
                         jqp.pyramid_bounds(jnp.asarray(sched), 5.0, 300.0, jnp.float64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
