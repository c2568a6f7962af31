"""Constraint solver, batched over envs: exact Newton on MuJoCo's primal
soft-constraint cost

    Phi(a) = 1/2 (a - a_smooth)' M (a - a_smooth) + sum s(J a - aref)

Counterpart of gym_quadruped_tpu/physics/solver.py `solve`. Per-row costs:
Huber for dof friction loss, one-sided quadratic for limits, and for
elliptic contacts the dual-cone projection cost, whose force law has three
zones:

    T = |(mu_i/mu_0) u_i|,  rho = mu_0^2 / D_t
    top     N >= mu_0 T           -> f = 0
    bottom  mu_0 T + rho Dn N <= 0 -> f = -D * u
    middle                        -> w = (mu_0 T + rho Dn N) / (1 + rho Dn),
                                     f_n = Dn (w - N), f_i = -D_i u_i (1 - w / (mu_0 T))

Each Newton iteration solves H p = -g with the batched SPD solve (the CUDA
kernel on the card), then takes a step length from a 15-point grid on the
convex 1-D derivative followed by 6 bisections.

`solve` is the plain version of the fused Newton kernel
(ops/newton_fused.py, csrc/newton_fused.cu), which runs this whole loop in
one launch. The physics step reaches `solve` through that wrapper: on CPU
tensors it runs this loop; on the card the kernel runs instead, and this
eager loop serves only to check and time it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym_quadruped_tpu_torch.ops.spd_solve import spd_solve_batched
from gym_quadruped_tpu_torch.physics.constraints import Efc


def _safe_norm(x, eps=1e-30):
    return torch.sqrt(torch.clamp_min((x * x).sum(-1), eps))


# ---------------------------------------------------------------------------------
# force laws (any leading shape; the last axis is the row / the cone block)
# ---------------------------------------------------------------------------------

def simple_force(u, D, fl, uni_f):
    """Row-separable force: one-sided quadratic (uni_f = 1) or Huber clamp."""
    f_uni = -D * torch.clamp_max(u, 0.0)
    f_hub = -torch.minimum(torch.maximum(D * u, -fl), fl)
    return uni_f * f_uni + (1.0 - uni_f) * f_hub


def simple_hess_weight(u, D, fl, uni_f):
    """Diagonal curvature of the simple-row costs at u."""
    c_uni = torch.where(u < 0, D, 0.0)
    c_hub = torch.where((D * u).abs() < fl, D, 0.0)
    return uni_f * c_uni + (1.0 - uni_f) * c_hub


def cone_force(u, D, mu, dim_mask):
    """Elliptic force of contact blocks u, D, dim_mask (..., 6), mu (..., 5)."""
    mu0 = mu[..., :1]
    N = u[..., :1]
    uf = u[..., 1:] * dim_mask[..., 1:]
    Dn = D[..., :1]
    rho = mu0 * mu0 / torch.clamp_min(D[..., 1:2], 1e-30)
    T = _safe_norm(uf * mu / mu0)[..., None]
    w = (mu0 * T + rho * Dn * N) / (1.0 + rho * Dn)
    f_bottom = -D * u * dim_mask
    fn_mid = Dn * (w - N)
    ff_mid = -D[..., 1:] * uf * (1.0 - w / torch.clamp_min(mu0 * T, 1e-30))
    f_mid = torch.cat([fn_mid, ff_mid], -1) * dim_mask
    return torch.where(N >= mu0 * T, 0.0, torch.where(w <= 0.0, f_bottom, f_mid))


def cone_hessian_rows(u, D, mu, dim_mask):
    """(..., C, 6, 6) closed-form block curvature -df/du of the elliptic
    force, the reference's cone_hessian_rows stacked into one tensor.

    Middle zone (W = (mu_0 T + rho Dn N)/(1 + rho Dn), s = mu_0 T,
    gamma_j = mu_j^2 u_j / s, beta_j = gamma_j / (1 + rho Dn)):
        -dfn/dN  = Dn (1 - alpha),  -dfn/du_j = -Dn beta_j  (alpha = rho Dn/(1 + rho Dn))
        -dfi/dN  = -D_i u_i alpha / s
        -dfi/du_j = D_i delta_ij (1 - W/s) - D_i u_i (beta_j - (W/s) gamma_j) / s
    Bottom zone: diag(D). Top zone: 0."""
    mu0 = mu[..., 0]
    N = u[..., 0]
    uf = u[..., 1:] * dim_mask[..., 1:]
    Dn = D[..., 0]
    rho = mu0 * mu0 / torch.clamp_min(D[..., 1], 1e-30)
    T = torch.sqrt(torch.clamp_min(((uf * mu / mu0[..., None]) ** 2).sum(-1), 1e-30))
    s = mu0 * T
    s_safe = torch.clamp_min(s, 1e-30)
    alpha = rho * Dn / (1.0 + rho * Dn)
    W = (s + rho * Dn * N) / (1.0 + rho * Dn)
    gamma = mu ** 2 * uf / s_safe[..., None]
    beta = gamma / (1.0 + rho * Dn)[..., None]
    Ws = W / s_safe
    Df = D[..., 1:] * dim_mask[..., 1:]

    col0 = -Df * uf * (alpha / s_safe)[..., None]                # (..., 5)
    diag = Df * (1.0 - Ws)[..., None]
    right = (beta - Ws[..., None] * gamma) / s_safe[..., None]
    Dfuf = Df * uf
    row0 = torch.cat([(Dn * (1.0 - alpha))[..., None], -Dn[..., None] * beta], -1)
    ff = torch.diag_embed(diag) + -Dfuf[..., :, None] * right[..., None, :]
    H = torch.cat([row0[..., None, :], torch.cat([col0[..., None], ff], -1)], -2)
    Hm = H * dim_mask[..., :, None] * dim_mask[..., None, :]
    Hb = torch.diag_embed(D * dim_mask * dim_mask)
    top = (N >= mu0 * T)[..., None, None]
    bot = (W <= 0.0)[..., None, None]
    return torch.where(top, 0.0, torch.where(bot, Hb, Hm))


def _cone_quad_rows(cJ, Hc):
    """sum_c cJ_c' Hc_c cJ_c for cJ (B, C, 6, v), Hc (B, C, 6, 6) -> (B, v, v):
    Hc cJ per block, then one flat product over the C*6 contraction rows."""
    B, C, _, v = cJ.shape
    t = Hc @ cJ                                                  # (B, C, 6, v)
    return cJ.reshape(B, C * 6, v).transpose(1, 2) @ t.reshape(B, C * 6, v)


# ---------------------------------------------------------------------------------
# Newton solve
# ---------------------------------------------------------------------------------

# Tolerance on the accepted step relative to |qacc| (f32 cannot resolve the
# f64 bar).
_TOL = {torch.float32: 1e-6, torch.float64: 1e-10}
_LS_T_MAX = 256.0


@functools.lru_cache(maxsize=8)
def _ls_grid(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The step-length grid geomspace(1e-3, 256, 15) in the working dtype,
    made once per device so a step copies nothing from the host."""
    return torch.as_tensor(np.geomspace(1e-3, _LS_T_MAX, 15), dtype=dtype, device=device)


def _mv(A, x):
    """(B, r, c) @ (B, c) -> (B, r)."""
    return (A @ x[..., None])[..., 0]


def _mtv(A, y):
    """A' y for A (B, r, c), y (B, r) -> (B, c)."""
    return (y[:, None, :] @ A)[:, 0]


def solve(M, a_smooth, efc: Efc, warmstart=None, iterations: int = 10,
          ls_iterations: int = 6, iterations_out=None, *, _tol=None):
    """Returns (qacc, f_simple, f_cone, qfrc_constraint), each batched.

    `iterations` caps the Newton loop. An env whose accepted step falls below
    _TOL (1 + |qacc|_inf) is done and its qacc frozen, as under the
    reference's vmapped while_loop. The loop ends when every env is done (one
    host sync per iteration) or at the cap. `iterations_out`, an int32 (B,)
    tensor, receives each env's count of Newton iterations.

    This is the plain version of the fused kernel (ops/newton_fused.py);
    `_tol=0` is its fixed-count form, which runs every env `iterations`
    times."""
    dtype = a_smooth.dtype
    B, nv = a_smooth.shape
    C = efc.con_J.shape[1]
    if efc.J.shape[1] == 0 and C == 0:
        if iterations_out is not None:
            iterations_out.zero_()
        return a_smooth, a_smooth.new_zeros(B, 0), a_smooth.new_zeros(B, 0, 6), \
            torch.zeros_like(a_smooth)

    unilateral = (efc.frictionloss <= 0).to(dtype)
    D_s = efc.active.to(dtype) * (1.0 / efc.R)
    fl = efc.frictionloss
    dim_mask, mu = efc.cone_dim_mask, efc.cone_mu
    D_c = efc.con_active.to(dtype)[..., None] * (1.0 / efc.con_R) * dim_mask
    cJ = efc.con_J
    cJ_flat = cJ.reshape(B, C * 6, nv)

    def forces(us, uc):
        return (simple_force(us, D_s, fl, unilateral),
                cone_force(uc, D_c, mu, dim_mask))

    # the same laws at k step lengths per env: row values (B, k, ...)
    D_s1, fl1, uni1 = D_s[:, None], fl[:, None], unilateral[:, None]
    D_c1, mu1, dim_mask1 = D_c[:, None], mu[:, None], dim_mask[:, None]

    def forces_k(us, uc):
        return (simple_force(us, D_s1, fl1, uni1),
                cone_force(uc, D_c1, mu1, dim_mask1))

    def rows(a):
        """(B, ns) simple and (B, C, 6) cone row values J a - aref."""
        return (_mv(efc.J, a) - efc.aref,
                _mv(cJ_flat, a).reshape(B, C, 6) - efc.con_aref)

    a = a_smooth if warmstart is None else warmstart
    tol = _TOL.get(dtype, 1e-6) if _tol is None else _tol
    grid = _ls_grid(dtype, a.device)
    trace_M = torch.diagonal(M, 0, 1, 2).sum(-1)
    reg = (1e-10 * trace_M / nv)[:, None, None] * torch.eye(nv, dtype=dtype, device=a.device)
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    n_iter = torch.zeros(B, dtype=torch.int32, device=a.device)

    for _ in range(iterations):
        n_iter += ~done
        us, uc = rows(a)
        fs, fc = forces(us, uc)
        r = a - a_smooth
        g = _mv(M, r) - _mtv(efc.J, fs) - _mtv(cJ_flat, fc.reshape(B, C * 6))

        cw = simple_hess_weight(us, D_s, fl, unilateral)
        H = M + efc.J.transpose(1, 2) @ (cw[..., None] * efc.J)
        if C:
            H = H + _cone_quad_rows(cJ, cone_hessian_rows(uc, D_c, mu, dim_mask))
        p = -spd_solve_batched(H + reg, g)

        # 1-D line search on the convex derivative phi'(t), from projections
        # computed once: every evaluation is elementwise
        Mp = _mv(M, p)
        pMp = (p * Mp).sum(-1, keepdim=True)
        pMr = (p * _mv(M, r)).sum(-1, keepdim=True)
        dus = _mv(efc.J, p)
        duc = _mv(cJ_flat, p).reshape(B, C, 6)

        def dphi(t):
            """phi'(t) at step lengths t (B, k) -> (B, k)."""
            fs_t, fc_t = forces_k(us[:, None] + t[..., None] * dus[:, None],
                                  uc[:, None] + t[..., None, None] * duc[:, None])
            return (pMr + t * pMp - (fs_t * dus[:, None]).sum(-1)
                    - (fc_t * duc[:, None]).sum((-1, -2)))

        # bracket: lo = the largest grid t with phi' < 0 (else 0),
        # hi = the smallest with phi' >= 0 (else the grid's end)
        neg = dphi(grid.expand(B, -1)) < 0
        lo = torch.where(neg, grid, 0.0).amax(-1, keepdim=True)
        hi = torch.where(neg, _LS_T_MAX, grid).amin(-1, keepdim=True)
        for _ in range(ls_iterations):
            mid = 0.5 * (lo + hi)
            v_neg = dphi(mid) < 0
            lo, hi = torch.where(v_neg, mid, lo), torch.where(v_neg, hi, mid)
        step = 0.5 * (lo + hi) * p
        a_new = a + step
        converged = step.abs().amax(-1) < tol * (1.0 + a_new.abs().amax(-1))
        a = torch.where(done[:, None], a, a_new)
        done = done | converged
        if bool(done.all()):
            break

    us, uc = rows(a)
    fs, fc = forces(us, uc)
    qfrc = _mtv(efc.J, fs) + _mtv(cJ_flat, fc.reshape(B, C * 6))
    if iterations_out is not None:
        iterations_out.copy_(n_iter)
    return a, fs, fc, qfrc
