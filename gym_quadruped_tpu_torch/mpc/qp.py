"""Condensed-QP solver for centroidal MPC: dense condensing + consensus ADMM.

Counterpart of gym_quadruped_tpu/mpc/qp.py, batched over a leading env axis
B. At H=12 the condensed decision vector is U in R^144 per env:

    min_U  1/2 U^T H U + q^T U      s.t.  U in C (per-leg friction pyramids)
    H = Su^T Q Su + R,  q = Su^T Q (Sx x0 - X_ref)

Consensus ADMM (z the cone-feasible copy; swing legs pinned to zero force):
    U <- (H + rho I)^-1 (rho (z - y) - q)
    z <- Pi_C(U + y);  y <- y + U - z

with (H + rho I)^-1 formed once per solve by Newton-Schulz (`spd_inverse`),
so that every ADMM iteration is one batched matrix-vector product. The
Newton-Schulz loop and the ADMM products run at full float32 whatever the
caller's matmul precision: TF32's 10-bit mantissa is the hazard that made
the reference pin Precision.HIGHEST (bf16 diverges there).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from gym_quadruped_tpu_torch.mpc.centroidal import NU, NX


@dataclasses.dataclass(frozen=True)
class MPCWeights:
    """Tracking weights (theta, p, omega, v ordering of the SRB state); the
    reference's classic convex-MPC tuning."""

    q_diag: tuple = (0.25, 0.25, 10.0,   # rpy
                     2.0, 2.0, 50.0,     # position
                     0.0, 0.0, 0.3,      # omega
                     0.2, 0.2, 0.2,      # v
                     0.0)                # augmented 1
    r_diag: float = 1e-5                 # force effort


@contextlib.contextmanager
def full_f32():
    """float32 matmuls on the card at full precision (no TF32) inside the
    block; the caller's setting is restored after it. The flag is cuBLAS's
    own, through the API the caller set it with: PyTorch refuses to read a
    setting made through both its legacy and its new API."""
    matmul = torch.backends.cuda.matmul
    try:
        attr, prev, full = 'allow_tf32', matmul.allow_tf32, False
    except RuntimeError:   # set through the new API alone (torch >= 2.9)
        attr, prev, full = 'fp32_precision', matmul.fp32_precision, 'ieee'
    setattr(matmul, attr, full)
    try:
        yield
    finally:
        setattr(matmul, attr, prev)


def _mv(M, v):
    """(B, n, m) @ (B, m) -> (B, n)."""
    return (M @ v[..., None])[..., 0]


def condense(A, B, x0, x_ref, q_diag, r_scalar):
    """Dense condensing over the horizon.

    Args:
        A: (B, H, NX, NX), B: (B, H, NX, NU), x0: (B, NX), x_ref: (B, H, NX)
        q_diag: (NX,) state weights, a sequence or a tensor on x0's device
    Returns:
        Hq (B, H NU, H NU), q (B, H NU)
    """
    nb, H = A.shape[:2]
    # running-row recursion: row_k = A_k row_{k-1} (+ B_k in block k), so the
    # whole (H NX, H NU) prediction matrix costs H products instead of H^2/2
    Sx_rows, Su_rows = [], []
    phi = torch.eye(NX, dtype=A.dtype, device=A.device).expand(nb, NX, NX)
    row = A.new_zeros(nb, NX, H * NU)
    for k in range(H):
        phi = A[:, k] @ phi
        row = A[:, k] @ row                      # a fresh tensor: the add is in place
        row[:, :, k * NU:(k + 1) * NU] += B[:, k]
        Sx_rows.append(phi)
        Su_rows.append(row)
    Sx = torch.stack(Sx_rows, 1)                 # (B, H, NX, NX)
    Su = torch.cat(Su_rows, 1)                   # (B, H NX, H NU)

    # a sequence is copied to the device here; a tensor on it is not
    Qd = torch.as_tensor(q_diag, dtype=x0.dtype).to(x0.device).repeat(H)
    xbar = _mv(Sx, x0[:, None, :]).reshape(nb, -1)
    r = xbar - x_ref.reshape(nb, -1)
    SuT = Su.transpose(1, 2)
    Hq = SuT @ (Qd[:, None] * Su) + r_scalar * torch.eye(H * NU, dtype=A.dtype, device=A.device)
    q = _mv(SuT, Qd * r)
    return Hq, q


def _project_wedge(t, n, mu):
    """Exact Euclidean projection of (t, n) pairs onto the 2D wedge |t| <= mu n."""
    inside = torch.abs(t) <= mu * n
    below = mu * torch.abs(t) <= -n          # polar cone: projects to the origin
    lam = torch.clamp_min((mu * torch.abs(t) + n) / (1.0 + mu * mu), 0.0)
    t_edge = torch.sign(t) * mu * lam
    t_new = torch.where(inside, t, torch.where(below, 0.0, t_edge))
    n_new = torch.where(inside, n, torch.where(below, 0.0, lam))
    return t_new, n_new


def project_pyramid(v, stance, mu, fz_min, fz_max, sweeps: int = 8):
    """Pi_C: exact per-leg-knot projection onto the friction pyramid
    {|fx| <= mu fz, |fy| <= mu fz, fz in [fz_min c, fz_max c]} by Dykstra's
    algorithm over the two wedges and the z-box. v (B, H NU), stance (B, H 4).

    Each set moves only some components, so Dykstra's increments are kept
    by component: the x-wedge's (x, z), the y-wedge's (y, z), the box's z.
    The components each set leaves alone have an increment of exactly 0,
    which the reference adds."""
    f = v.reshape(v.shape[0], -1, 3)
    fx, fy, fz = f.unbind(-1)
    lo, hi = fz_min * stance, fz_max * stance
    p0x = p0z = p1y = p1z = p2z = torch.zeros_like(fx)
    for _ in range(sweeps):
        # set 1: x-wedge
        wx, wz = fx + p0x, fz + p0z
        fx, fz = _project_wedge(wx, wz, mu)
        p0x, p0z = wx - fx, wz - fz
        # set 2: y-wedge
        wy, wz = fy + p1y, fz + p1z
        fy, fz = _project_wedge(wy, wz, mu)
        p1y, p1z = wy - fy, wz - fz
        # set 3: z-box
        wz = fz + p2z
        fz = torch.clamp(wz, lo, hi)
        p2z = wz - fz
    # final safety clamp so the return value is strictly feasible
    fz = torch.clamp(fz, lo, hi)
    fx = torch.clamp(fx, -mu * fz, mu * fz)
    fy = torch.clamp(fy, -mu * fz, mu * fz)
    return torch.stack([fx, fy, fz], -1).reshape(v.shape)


_NS_ITERS = 18
_NS_SHIFT = 0.02


def spd_inverse(K, swing_mask, iters: int = _NS_ITERS):
    """Matmul-only SPD inverse for the ADMM x-update (Newton-Schulz,
    X <- X (2I - K X)), per env: K (B, n, n), swing_mask (B, n) bool.

    The swing columns of K are exactly (r_diag + rho) I (their Su columns
    are zero): they are lifted by `_NS_SHIFT` before the iteration and
    restored by an exact diagonal correction after it. 18 iterations from
    the identity over the row-sum bound reach the f32 floor
    (||I - XK||_F ~ 2e-3). `base` and `lam` are each env's own: a reduction
    over the batch would be wrong, silently so on identical envs."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    # swing diagonal = r_diag + rho exactly; the min over the diagonal
    # recovers it without threading the weight constants through
    base = torch.diagonal(K, dim1=-2, dim2=-1).amin(-1)                  # (B,)
    K2 = K + torch.diag_embed(swing_mask.to(K.dtype) * _NS_SHIFT)
    lam = torch.abs(K2).sum(-1).amax(-1)                                 # (B,) >= lmax(K2)
    X = eye / lam[:, None, None]
    two_eye = 2.0 * eye
    with full_f32():
        for _ in range(iters):
            X = X @ (two_eye - K2 @ X)
    corr = torch.where(swing_mask, (1.0 / base - 1.0 / (base + _NS_SHIFT))[:, None], 0.0)
    return X + torch.diag_embed(corr)


def swing_components(schedule):
    """(B, H 12) bool: the force components of the swing legs' knots, from
    the contact schedule (B, H, 4)."""
    B = schedule.shape[0]
    return (schedule.reshape(B, -1, 1) == 0).expand(-1, -1, 3).reshape(B, -1)


def admm_solve(Hq, q, schedule, mu, fz_min, fz_max, iterations: int = 30,
               rho: float = 1e-4, warmstart=None):
    """Fixed-iteration consensus ADMM over B envs: Hq (B, n, n), q (B, n),
    schedule (B, H, 4). Returns (U_feasible (B, n), (U, z, y) warm start).

    The x-update uses an explicit K^-1 (`spd_inverse`) formed once per
    solve, so each iteration is one batched matrix-vector product."""
    n = Hq.shape[-1]
    K = Hq + rho * torch.eye(n, dtype=Hq.dtype, device=Hq.device)
    stance = schedule.reshape(schedule.shape[0], -1).to(Hq.dtype)       # (B, H 4)
    Kinv = spd_inverse(K, swing_components(schedule))

    if warmstart is None:
        U = torch.zeros_like(q)
        z = torch.zeros_like(q)
        y = torch.zeros_like(q)
    else:
        U, z, y = warmstart
    with full_f32():
        for _ in range(iterations):
            U = _mv(Kinv, rho * (z - y) - q)
            z = project_pyramid(U + y, stance, mu, fz_min, fz_max)
            y = y + U - z
    return z, (U, z, y)


def pyramid_constraints(H: int, mu: float, dtype=torch.float64) -> torch.Tensor:
    """Constraint-matrix form of the pyramid set (for handing the same QP to
    a reference CPU solver): rows per leg-knot
    [fx - mu fz, -fx - mu fz, fy - mu fz, -fy - mu fz, fz]."""
    g_leg = np.array([
        [1, 0, -mu],
        [-1, 0, -mu],
        [0, 1, -mu],
        [0, -1, -mu],
        [0, 0, 1.0],
    ])
    G = np.zeros((5 * 4 * H, H * NU))
    for k in range(H):
        for leg in range(4):
            r0 = (k * 4 + leg) * 5
            c0 = k * NU + leg * 3
            G[r0:r0 + 5, c0:c0 + 3] = g_leg
    return torch.as_tensor(G, dtype=dtype)


def pyramid_bounds(schedule, fz_min, fz_max, dtype=torch.float64):
    """(l, u) for pyramid_constraints' rows from the (H, 4) contact schedule."""
    c = schedule.reshape(-1).to(dtype)
    big = 1e9
    l_leg = torch.stack([-big * torch.ones_like(c)] * 4 + [fz_min * c], -1)
    u_leg = torch.stack([torch.zeros_like(c)] * 4 + [fz_max * c], -1)
    return l_leg.reshape(-1), u_leg.reshape(-1)
