"""The port on the card: the CUDA SPD kernel and the fused Newton kernel
against their plain versions, and a short f32 run of the step on the card
against the same steps in f64 on the CPU. Every test here needs an NVIDIA
GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies are installed:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.ops import spd_solve as spd
from gym_quadruped_tpu_torch.physics import engine, solver


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', [(4096, 18), (4097, 18), (100, 7), (64, 32)])
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


@pytest.mark.cuda
@pytest.mark.parametrize('B', [64, 4097])
@pytest.mark.parametrize('form', ['solve_batched', 'solve_batched_bt'])
def test_newton_kernel_matches_plain(card, B, form):
    # soft contact states, which f32 Newton solves to convergence: the
    # keyframe lowered up to 5 mm, qvel 0, small torques
    dm = load_model('spot', 'flat', device=card)
    rng = np.random.RandomState(B)
    qpos = np.tile(dm.m.key_qpos[0], (B, 1))
    qpos[:, 2] -= rng.uniform(0, 0.005, B)
    ctrl = rng.uniform(-0.5, 0.5, (B, dm.m.nu))
    as_card = lambda x: torch.as_tensor(x, dtype=torch.float32, device=card)
    fwd = engine.forward(dm, as_card(qpos), torch.zeros(B, dm.m.nv, device=card),
                         as_card(ctrl))
    assert bool(fwd.efc.con_active.any())
    before = nf.launches
    got = getattr(nf, form)(fwd.M, fwd.qacc_smooth, fwd.efc)
    torch.cuda.synchronize()
    assert nf.launches == before + 1
    ref = solver.solve(fwd.M, fwd.qacc_smooth, fwd.efc,
                       _tol=0.0 if form == 'solve_batched_bt' else None)
    # the plain version's own f32 rounding differs: 1e-4 of 1 + max|ref|
    for g, r in zip(got, ref):
        err = ((g - r).abs().max() / (1 + r.abs().max())).item()
        assert err < 1e-4, err


@pytest.mark.cuda
def test_step_on_card_matches_cpu_f64(card):
    B, T = 64, 20
    dm = load_model('spot', 'flat', device=card)
    dm64 = load_model('spot', 'flat', device='cpu', dtype=torch.float64)
    ctrls = np.random.RandomState(0).uniform(-2, 2, (T, B, dm.m.nu))
    qpos = np.tile(dm.m.key_qpos[0], (B, 1))
    q, v, w = (torch.as_tensor(x, dtype=torch.float32, device=card)
               for x in (qpos, np.zeros((B, 18)), np.zeros((B, 18))))
    q64, v64, w64 = (torch.as_tensor(x) for x in (qpos, np.zeros((B, 18)), np.zeros((B, 18))))
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
    assert bool(f.efc.con_active.any())
    # f32 against f64 over 20 steps of 2 ms: far inside the 1e-3 qpos bar
    err = (q.double().cpu() - q64).abs().max().item()
    assert err < 1e-3, err
