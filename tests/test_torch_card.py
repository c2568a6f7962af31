"""The port on the card: the CUDA SPD kernel and the fused Newton kernel
against their plain versions, a short f32 run of the step on the card
against the same steps in f64 on the CPU (go2/perlin's from the keyframe
lifted out of the terrain and lowered onto it), and the env layer on the card
(go2/flat reset and steps, launches per step, card against CPU f64), a
small mixed-robot batch (launches per step, each group equal to its
homogeneous env), a checkpoint resumed on the card, the single-env gym
adapter (launches per step and per Forward refresh, accessors against the
CPU's f64) and go2/slippery against the CPU's f64 with the feet on its
world boxes. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies are installed:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.env import MixedQuadrupedEnv, QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.models.scene_starts import feature_start, world_box_slots
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.ops import spd_solve as spd
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import collision, engine, kinematics, solver
from gym_quadruped_tpu_torch.physics.constraints import constraint_layout
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask
from gym_quadruped_tpu_torch.sensors import HeightMap
from gym_quadruped_tpu_torch.utils import checkpoint
from gym_quadruped_tpu_torch.utils.tree import leaves_with_path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', [(4096, 18), (4097, 18), (100, 7), (64, 32), (4097, 32),
                                 (4097, 1)])
def test_kernel_matches_plain(card, B, n):
    gen = torch.Generator(device=card).manual_seed(B + n)
    X = torch.randn(B, n, n, generator=gen, device=card)
    A = (X @ X.transpose(1, 2) + n * torch.eye(n, device=card)).contiguous()
    b = torch.randn(B, n, generator=gen, device=card)
    before = spd.launches
    x = spd.spd_solve_batched(A, b)
    torch.cuda.synchronize()
    assert spd.launches == before + 1
    x_plain = spd.unrolled_chol_solve_torch(A, b)
    # f32 Cholesky of well-conditioned systems, the reference kernel's bar
    err = ((x - x_plain).abs().max() / (1 + x_plain.abs().max())).item()
    assert err < 1e-4, err


@pytest.mark.cuda
def test_kernel_raises_on_f64(card):
    A = torch.eye(18, dtype=torch.float64, device=card).expand(4, 18, 18).contiguous()
    with pytest.raises(ValueError, match='float32'):
        spd.spd_solve_batched(A, torch.ones(4, 18, dtype=torch.float64, device=card))


def _clearance(dm):
    """How far the keyframe's nearest contact slot is from touching (0 when
    it touches)."""
    kin = kinematics.fk(dm, torch.as_tensor(dm.m.key_qpos[:1], dtype=dm.dtype, device=dm.device))
    return max(0.0, collision.collide(dm, kin).dist.min().item())


def _soft_states(card, B, limits=False, robot='spot', press=0.0):
    """Soft contact states, which f32 Newton solves to convergence: the
    keyframe lowered by its clearance (0 for spot and go2, whose feet press
    into the floor), `press` and up to 5 mm more, qvel 0, small torques;
    with `limits`, the first limited joint (a hip) of every fourth env 0.01
    rad past its range."""
    dm = load_model(robot, 'flat', device=card)
    m = dm.m
    rng = np.random.RandomState(B)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 2] -= _clearance(dm) + press + rng.uniform(0, 0.005, B)
    if limits:
        j = constraint_layout(m).lim_jnts[0]
        qpos[::4, m.jnt_qposadr[j]] = m.jnt_range[j, 1] + 0.01
    ctrl = rng.uniform(-0.5, 0.5, (B, m.nu))
    as_card = lambda x: torch.as_tensor(x, dtype=torch.float32, device=card)
    fwd = engine.forward(dm, as_card(qpos), torch.zeros(B, m.nv, device=card), as_card(ctrl))
    assert _touches(fwd.efc, m)
    return fwd.M, fwd.qacc_smooth, fwd.efc


def _touches(efc, m):
    """Whether a contact is active: a cone block or a pyramidal row."""
    first, _, _ = pcon.pyramidal_rows(constraint_layout(m))
    return bool(efc.con_active.any() or efc.active[:, first:].any())


def _check_newton(M, a_smooth, efc, form, iterations=10, envs_bar=0.02):
    before = nf.launches
    it = torch.zeros(a_smooth.shape[0], dtype=torch.int32, device=a_smooth.device)
    got = getattr(nf, form)(M, a_smooth, efc, iterations=iterations, iterations_out=it)
    torch.cuda.synchronize()
    assert nf.launches == before + 1
    it_ref = torch.zeros_like(it)
    ref = solver.solve(M, a_smooth, efc, iterations=iterations, iterations_out=it_ref,
                       _tol=0.0 if form == 'solve_batched_bt' else None)
    # the plain version's own f32 rounding differs: 1e-4 of 1 + max|ref|
    for g, r in zip(got, ref):
        if r.numel():
            err = ((g - r).abs().max() / (1 + r.abs().max())).item()
            assert err < 1e-4, err
    # f32 rounding (~3e-7 of 1 + max|qacc|) is the order of the converged step
    # (tol 1e-6): an env near convergence may stop one iteration apart
    assert int((it != it_ref).sum()) <= envs_bar * it.numel()
    assert abs(it.float().mean() - it_ref.float().mean()).item() <= 0.01
    # rows compacted away get exact zeros
    assert bool((got[1][~efc.active] == 0).all() and (got[2][~efc.con_active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize('B', [64, 4097])
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_matches_plain(card, B, form):
    _check_newton(*_soft_states(card, B), form)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_active_limits(card, form):
    M, a_smooth, efc = _soft_states(card, 4097, limits=True)
    n_active = efc.active.sum(1)
    assert int(n_active.max()) > int(n_active.min())   # mixed active and inactive limits
    _check_newton(M, a_smooth, efc, form)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_without_rows(card, form):
    # ns = C = 0 still launches the kernel, which writes a_smooth
    M, a_smooth, efc = _soft_states(card, 4097)
    efc = dataclasses.replace(efc, **{f.name: getattr(efc, f.name)[:, :0].contiguous()
                                      for f in dataclasses.fields(efc)
                                      if getattr(efc, f.name) is not None})
    _check_newton(M, a_smooth, efc, form)
    qacc = getattr(nf, form)(M, a_smooth, efc, warmstart=torch.zeros_like(a_smooth))[0]
    assert torch.equal(qacc, a_smooth)


def synthetic_rows(B, nv=12, ns=8, C=3, seed=0, device='cpu'):
    """A seeded, well-conditioned Newton problem of any size: M = X X'/nv + I,
    simple rows that are unit rows in even envs and dense in odd ones (half
    Huber, half one-sided), random cone blocks whose friction R follows mu as
    make_efc's does (R_i = R_n (mu_0 / mu_i)^2, which keeps the cone convex);
    about 70% of rows active."""
    rng = np.random.RandomState(seed)
    X = rng.randn(B, nv, nv)
    M = X @ X.transpose(0, 2, 1) / nv + np.eye(nv)
    J = np.zeros((B, ns, nv))
    J[:, np.arange(ns), rng.randint(0, nv, ns)] = rng.choice([-1.0, 1.0], ns)
    J[1::2] += 0.3 * rng.randn(*J[1::2].shape)
    mu0 = rng.uniform(0.5, 1.0, (B, C, 1))
    mu = np.concatenate([mu0, mu0, np.full((B, C, 1), 0.01), np.full((B, C, 2), 0.001)], -1)
    R_n = rng.uniform(0.5, 2.0, (B, C, 1))
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device).contiguous()
    efc = pcon.Efc(
        J=t(J), aref=t(rng.randn(B, ns)), R=t(rng.uniform(0.5, 2.0, (B, ns))),
        active=t(rng.rand(B, ns) < 0.7, torch.bool),
        frictionloss=t(np.where(np.arange(ns) % 2 == 0, rng.uniform(0.1, 1.0, (B, ns)), 0.0)),
        con_J=t(0.3 * rng.randn(B, C, 6, nv)), con_aref=t(rng.randn(B, C, 6)),
        con_R=t(np.concatenate([R_n, R_n * (mu0 / mu) ** 2], -1)),
        con_active=t(rng.rand(B, C) < 0.7, torch.bool), cone_mu=t(mu),
        cone_dim_mask=t(np.ones((B, C, 6))), cone_dist=t(np.zeros((B, C))),
        cone_sel=t(np.zeros((B, C)), torch.int64))
    return t(M), t(rng.randn(B, nv)), efc


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_any_size_and_dense_rows(card, form):
    # nv = 12 builds the kernel for 12 dofs; odd envs' dense simple rows
    # take the dense J' diag(cw) J
    _check_newton(*synthetic_rows(4097, device=card), form)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_matches_plain_go2(card, form):
    # go2's shapes: ns 24, C 32 culled from 1,180 cone slots, condim 3 and 6.
    # Its soft states need up to 15 iterations from a_smooth (f32 and f64), so
    # both solves get a cap of 30 to converge; more envs then stop one
    # iteration apart than on spot/flat: the eager f32 and f64 solves
    # themselves do in 3.6% of the envs (chip_smoke.py phase 10)
    M, a_smooth, efc = _soft_states(card, 4097, robot='go2')
    assert efc.con_J.shape[1] == 32
    dims = efc.cone_dim_mask.sum(-1)[efc.con_active]
    assert bool((dims == 3).any()) and bool((dims == 6).any())
    _check_newton(M, a_smooth, efc, form, iterations=30, envs_bar=0.05)


@pytest.mark.cuda
def test_newton_kernel_residency_go2(card):
    # shared memory is sized by C: at C = 32 a block of 2 envs takes ~61 KB
    blocks, envs, smem = nf.occupancy(18, 24, 32)
    assert blocks * envs >= 6, (blocks, envs, smem)


@pytest.mark.cuda
def test_newton_kernel_residency(card):
    # 16 envs per SM at the main path's sizes (nv 18, ns 24, C 10)
    blocks, envs, smem = nf.occupancy(18, 24, 10)
    assert blocks * envs >= 16, (blocks, envs, smem)


def _terrain_start(dm):
    """The keyframe, which starts buried in a heightfield, lifted out of it
    by the env's rule, then lowered along the nearest foot's normal until
    that foot presses 1 mm into it (chip_smoke.py's start on the perlin
    scenes)."""
    key = torch.as_tensor(dm.m.key_qpos[:1], dtype=dm.dtype)
    lifted, _ = QuadrupedEnv(dm.m.robot, scene=dm.m.scene, model=dm)._lift_until_no_contact(key)
    con = collision.collide(dm, kinematics.fk(dm, lifted))
    foot = torch.as_tensor(np.any(feet_slot_mask(dm.m) > 0, axis=0))
    i = int(torch.where(foot, con.dist[0], torch.inf).argmin())
    start = lifted[0].numpy().copy()
    start[2] -= max(0.0, float(con.dist[0, i] / con.normal[0, i, 2])) + 0.001
    return start


def _card_against_cpu(card, robot, T=20, scene='flat'):
    B = 64
    dm = load_model(robot, scene, device=card)
    dm64 = load_model(robot, scene, device='cpu', dtype=torch.float64)
    nv = dm.m.nv
    ctrls = np.random.RandomState(0).uniform(-2, 2, (T, B, dm.m.nu))
    qpos = np.tile(dm.m.key_qpos[0], (B, 1))
    if scene == 'perlin':
        qpos = np.tile(_terrain_start(dm64), (B, 1))
    q, v, w = (torch.as_tensor(x, dtype=torch.float32, device=card)
               for x in (qpos, np.zeros((B, nv)), np.zeros((B, nv))))
    q64, v64, w64 = (torch.as_tensor(x) for x in (qpos, np.zeros((B, nv)), np.zeros((B, nv))))
    spd.launches = nf.launches = 0
    for t in range(T):
        q, v, f = engine.step_batched(dm, q, v, torch.as_tensor(
            ctrls[t], dtype=torch.float32, device=card), warmstart=w)
        w = f.qacc
        q64, v64, f64 = engine.step_batched(dm64, q64, v64, torch.as_tensor(ctrls[t]),
                                            warmstart=w64)
        w64 = f64.qacc
    # per step: the smooth solve and Euler on the SPD kernel, the Newton
    # solve in one launch of the fused kernel
    assert spd.launches == 2 * T
    assert nf.launches == T
    assert _touches(f.efc, dm.m)
    # f32 against f64 over 20-40 steps of 2 ms: far inside the 1e-3 qpos bar
    err = (q.double().cpu() - q64).abs().max().item()
    assert err < 1e-3, err


@pytest.mark.cuda
def test_step_on_card_matches_cpu_f64(card):
    _card_against_cpu(card, 'spot')


@pytest.mark.cuda
def test_step_on_card_matches_cpu_f64_go2(card):
    _card_against_cpu(card, 'go2')


@pytest.mark.cuda
def test_step_on_card_matches_cpu_f64_go2_perlin(card):
    # from the keyframe lifted out of the terrain and lowered onto it
    _card_against_cpu(card, 'go2', scene='perlin')


@pytest.mark.cuda
@pytest.mark.parametrize('robot', ['aliengo', 'b2'])
def test_step_on_card_matches_cpu_f64_pyramidal(card, robot):
    # the feet start 12.7 mm (aliengo) and 17.9 mm (b2) above the floor and
    # touch it after ~25 and ~30 steps: 40 steps reach the pyramidal rows
    _card_against_cpu(card, robot, T=40)


@pytest.mark.cuda
@pytest.mark.parametrize('ns', [148, 160, 402, 443, 1058])
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_pyramidal_sizes(card, ns, form):
    # aliengo's ns (148), the old cap (160), mini_cheetah/flat's (402),
    # go1's (443) and mini_cheetah/perlin's (1,058, one env per block),
    # C = 0: about 70% of the rows
    # active, so every 32-row word of the active-row ballot has some; odd
    # envs' dense rows take the dense J' diag(cw) J, as pyramidal rows do
    M, a_smooth, efc = synthetic_rows(4097, nv=18, ns=ns, C=0, device=card)
    for w in range(0, ns, 32):
        assert bool(efc.active[:, w:w + 32].any(0).all()), w
    _check_newton(M, a_smooth, efc, form)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_matches_plain_aliengo(card, form):
    # aliengo's rows (ns 148, C 0), the keyframe pressed 3 cm past its
    # clearance: the body's boxes touch too, and active pyramidal rows reach
    # past row 64
    M, a_smooth, efc = _soft_states(card, 4097, robot='aliengo', press=0.03)
    assert efc.J.shape[1] == 148 and efc.con_J.shape[1] == 0
    assert int(efc.active.nonzero()[:, 1].max()) >= 64
    _check_newton(M, a_smooth, efc, form)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_matches_plain_b2(card, form):
    # b2's rows (ns 140: 12 limit rows, then 32 culled slots of 4 pyramidal
    # rows), its four sphere feet on the floor
    M, a_smooth, efc = _soft_states(card, 4097, robot='b2')
    assert efc.J.shape[1] == 140 and efc.con_J.shape[1] == 0
    _check_newton(M, a_smooth, efc, form)


@pytest.mark.cuda
@pytest.mark.parametrize('ns', [140, 148, 158])
def test_newton_kernel_residency_pyramidal(card, ns):
    # b2, aliengo and hyqreal2 (C = 0): ~20-21 KB of shared memory per env,
    # so at least 5 blocks of 2 envs per SM
    blocks, envs, smem = nf.occupancy(18, ns, 0)
    assert blocks * envs >= 10, (blocks, envs, smem)


@pytest.mark.cuda
def test_env_go2_reset_and_steps(card):
    # a random reset, then each env.step launches the step's kernels alone
    env = QuadrupedEnv('go2', ground_friction_coeff=(0.5, 1.5))
    gen = torch.Generator(device=card).manual_seed(0)
    state, obs = env.reset(gen, 256)
    assert not bool(obs['feet_pos:base'].isnan().any())
    spd.launches = nf.launches = 0
    for _ in range(10):
        action = torch.rand(256, env.model.m.nu, generator=gen, device=card) * 4 - 2
        state, obs, reward, term, trunc, info = env.step(state, action)
    assert (spd.launches, nf.launches) == (20, 10)
    for x in [state.qpos, state.qvel, *obs.values()]:
        assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_env_on_card_matches_cpu_f64(card):
    # 64 envs reset at the keyframe with per-env friction, 20 steps on the
    # card in f32 and on the CPU in f64 from the card's reset state, at the
    # Newton cap of 30 (go2's f32 solve does not converge at 10 on every
    # state: chip_smoke.py phases 10 and 32)
    cfg = dict(ground_friction_coeff=(0.5, 1.5), solver_iterations=30)
    env = QuadrupedEnv('go2', **cfg)
    cpu = QuadrupedEnv('go2', model=load_model('go2', 'flat', device='cpu',
                                               dtype=torch.float64), **cfg)
    gen = torch.Generator(device=card).manual_seed(1)
    state, _ = env.reset(gen, 64, qpos=torch.as_tensor(env.model.m.key_qpos[0], device=card))
    state64 = state.to('cpu', torch.float64)
    actions = torch.rand(20, 64, env.model.m.nu, generator=gen, device=card) * 4 - 2
    for a in actions:
        state = env.step(state, a)[0]
        state64 = cpu.step(state64, a.double().cpu())[0]
    err = (state.qpos.double().cpu() - state64.qpos).abs().max().item()
    assert err < 1e-3, err


def _assert_same(a, b):
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert x.device == y.device and torch.equal(x, y), key


@pytest.mark.cuda
def test_mixed_batch_on_card(card):
    # go2 64 + mini_cheetah 64: 2 SPD and 1 Newton launch per group and step,
    # and each group's envs step bit for bit as its own homogeneous env
    obs = ('qpos', 'qvel', 'contact_state')
    env = MixedQuadrupedEnv([('go2', 64), ('mini_cheetah', 64)], state_obs_names=obs)
    gen = torch.Generator(device=card).manual_seed(0)
    state0, _ = env.reset(gen)
    actions = torch.rand(5, 128, env.nu_max, generator=gen, device=card) * 4 - 2
    spd.launches = nf.launches = 0
    state = state0
    for a in actions:
        state, out, *_ = env.step(state, a)
    assert (spd.launches, nf.launches) == (20, 10)
    assert out['qpos'].shape == (128, 19) and bool(torch.isfinite(out['qvel']).all())
    for g, (e, rows) in enumerate(zip(env.groups, (slice(0, 64), slice(64, 128)))):
        alone = QuadrupedEnv(e.robot_name, state_obs_names=obs, model=e.model)
        s = state0[g]
        for a in actions:
            s = alone.step(s, a[rows])[0]
        _assert_same(s, state[g])


@pytest.mark.cuda
def test_checkpoint_resume_on_card(card, tmp_path):
    # a go2 env with a heightmap: 3 steps, a checkpoint with the generator,
    # 5 steps on; restored with a fresh generator, the same 5 steps bit for bit
    env = QuadrupedEnv('go2', sensors=(HeightMap,), state_obs_names=('qpos', 'height_map_z'),
                       ground_friction_coeff=(0.5, 1.5))
    gen = torch.Generator(device=card).manual_seed(2)

    def run(state, generator, n):
        for _ in range(n):
            action = torch.rand(32, 12, generator=generator, device=card) * 4 - 2
            state = env.step(state, action, generator)[0]
        return state

    state = run(env.reset(gen, 32)[0], gen, 3)
    checkpoint.save(tmp_path / 'go2.npz', state, gen)
    want = run(state, gen, 5)
    fresh = torch.Generator(device=card)
    restored = checkpoint.restore(tmp_path / 'go2.npz', want, fresh)
    _assert_same(restored, state)
    _assert_same(run(restored, fresh, 5), want)


@pytest.mark.cuda
def test_gym_adapter_on_card(card):
    # the single-env adapter on the card: each step launches the step's
    # kernels alone, a Forward refresh one of each; its accessors match the
    # same adapter's on the CPU in f64 at the same state
    from gym_quadruped_tpu_torch.env.gym_adapter import QuadrupedGymEnv
    env = QuadrupedGymEnv(robot='go2', solver_iterations=30)
    assert env.core.model.device.type == 'cuda'
    cpu = QuadrupedGymEnv(robot='go2', solver_iterations=30,
                          model=load_model('go2', 'flat', device='cpu', dtype=torch.float64))
    obs = env.reset(seed=0)
    assert all(isinstance(v, np.ndarray) and np.isfinite(v).all() for v in obs.values())
    rng = np.random.RandomState(0)
    spd.launches = nf.launches = 0
    for _ in range(5):
        obs, reward, term, trunc, info = env.step(rng.uniform(-2, 2, 12))
    assert (spd.launches, nf.launches) == (10, 5)
    assert isinstance(reward, float) and isinstance(term, bool)
    state = env._state
    state.qpos[:, :2] = 0.0       # at the origin, where f32 resolves positions finely
    cpu._state = state.to('cpu', torch.float64)
    env._fwd = None
    spd.launches = nf.launches = 0
    jac = env.feet_jacobians('base')
    assert (spd.launches, nf.launches) == (1, 1)
    want = cpu.feet_jacobians('base')
    for leg in ('FL', 'FR', 'RL', 'RR'):
        assert np.abs(jac[leg] - want[leg]).max() < 1e-5
    assert np.abs(env.feet_jacobians_dot()['FL'] - cpu.feet_jacobians_dot()['FL']).max() < 1e-4
    assert np.abs(env.com - cpu.com).max() < 1e-5


@pytest.mark.cuda
def test_slippery_on_card_matches_cpu_f64(card):
    # go2/slippery at full width: 32 envs on each of the two surfaces
    # (`feature_start`), 20 steps on the card in f32 and on the CPU in f64
    # at the Newton cap of 30; the feet stand on the world boxes throughout
    dm = load_model('go2', 'slippery', device=card)
    dm64 = load_model('go2', 'slippery', device='cpu', dtype=torch.float64)
    lay = constraint_layout(dm.m)
    world_box = world_box_slots(dm)
    qpos = feature_start(dm, 64, torch.Generator(device=card).manual_seed(0))
    qvel = torch.zeros(64, dm.m.nv, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    ctrls = torch.rand(20, 64, 12, generator=gen, device=card) * 4 - 2
    q, v, w = qpos, qvel, torch.zeros_like(qvel)
    q64, v64, w64 = (x.double().cpu() for x in (qpos, qvel, w))
    spd.launches = nf.launches = 0
    for c in ctrls:
        q, v, f = engine.step_batched(dm, q, v, c, warmstart=w, solver_iterations=30)
        w = f.qacc
        touching = ((f.contacts.dist < torch.as_tensor(lay.con_incl, device=card))
                    & world_box).sum(1)
        assert bool((touching > 0).all())
        q64, v64, f64 = engine.step_batched(dm64, q64, v64, c.double().cpu(), warmstart=w64,
                                            solver_iterations=30)
        w64 = f64.qacc
    assert (spd.launches, nf.launches) == (40, 20)
    err = (q.double().cpu() - q64).abs().max().item()
    assert err < 1e-3, err
