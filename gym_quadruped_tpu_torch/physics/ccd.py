"""Convex contact by support-function SAT, pattern refinement and MuJoCo's
multiccd perturbation manifold, for the capsule-box, cylinder-box and
mesh pairs (convex hulls given by their vertices), and the SAT, refinement
and witness of the heightfield's box, cylinder and mesh pairs (one contact
per prism, no manifold).

Counterpart of gym_quadruped_tpu/physics/ccd.py. MuJoCo collides convex pairs with its native CCD (GJK/EPA) plus
multiccd: one penetration direction and depth per pair, then up to 4 more
manifold points from perturbed configurations. The perturbation rule the
reference decoded from MuJoCo 3.10:

  for each tangent axis t in {t1, t2} of the contact frame and sign s in {+,-}:
    rotate geom A by R(t, -s*eps) about A's center,
           geom B by R(t, +s*eps) about B's center   (eps = 1e-3 rad),
    re-run single-contact CCD on the perturbed pair,
    report its witness midpoint with the shared unperturbed depth;
  contacts closer than a dedup tolerance to an earlier one are dropped.

Every function works over arbitrary leading dims with vectors on a trailing
axis of 3. Support and clip helpers take poses (p, R) and sizes whose
leading dims broadcast against those of the direction or point.
"""

from __future__ import annotations

import torch

EPS_PERTURB = 1e-3    # multiccd perturbation angle
_DEDUP = 5e-5         # manifold dedup tolerance
_FACE_TOL = 2.5e-4    # support-face tie tolerance
_KAPPA = 3e-7         # witness: overlap lens kept in the touch-point refinement
_SNAP = 0.02          # snap_polish: axis components below this are tried at 0


def _cross(u, v):
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2, u0 * v1 - u1 * v0], -1)


def _dot(u, v):
    return (u * v).sum(-1)


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _first_true(mask):
    """Index of the first True along the last axis (0 where none is)."""
    return mask.to(torch.uint8).argmax(-1)


def _take(x, idx):
    """x (..., N, 3) at idx (...,) -> (..., 3)."""
    return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]


def tangents(n):
    """Orthonormal tangent pair for unit normals n (..., 3): t1 = n x ref,
    ref the z axis unless n is within 0.99 of it, then the x axis."""
    nx, ny, nz = n.unbind(-1)
    use_z = nz.abs() < 0.99
    zero = torch.zeros_like(nx)
    # n x (0, 0, 1) = (ny, -nx, 0); n x (1, 0, 0) = (0, nz, -ny)
    t1 = torch.stack([torch.where(use_z, ny, zero), torch.where(use_z, -nx, nz),
                      torch.where(use_z, zero, -ny)], -1)
    t1 = t1 / torch.clamp_min(_norm(t1, keepdim=True), 1e-30)
    return t1, _cross(n, t1)


def axis_angle(axis, ang):
    """Rotation matrices (..., 3, 3) about unit axes (..., 3) by ang (...,)."""
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    C = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], -2)


def perturb_rots(n, eps=EPS_PERTURB):
    """The 4 multiccd perturbations for contact normals n (..., 3): (Ra, Rb),
    each (..., 4, 3, 3), Ra[k] for geom A's orientation and Rb[k] for geom
    B's, about their centers. Axes t1, t1, t2, t2 with angles +eps, -eps
    (the mesh pairs take eps = 1.75e-3)."""
    t1, t2 = tangents(n)
    axes = torch.stack([t1, t1, t2, t2], -2)
    e = n.new_full(n.shape[:-1], eps)
    ang = torch.stack([e, -e, e, -e], -1)
    return axis_angle(axes, -ang), axis_angle(axes, ang)


# ---------------------------------------------------------------------------------
# support functions: d (..., 3); poses p (..., 3) / R (..., 3, 3) broadcast
# ---------------------------------------------------------------------------------

def _dotR(d, R):
    """d @ R (world direction -> local)."""
    return (d[..., :, None] * R).sum(-2)


def _dotRT(v, R):
    """v @ R.T (local vector -> world)."""
    return (R * v[..., None, :]).sum(-1)


def support_box(d, p, R, size):
    dl = _dotR(d, R)
    return p + _dotRT(torch.where(dl >= 0, size, -size), R)


def support_cap(d, p, R, radius, halflen):
    a = R[..., :, 2]
    da = _dot(d, a)
    return p + (torch.sign(da) * halflen)[..., None] * a + radius[..., None] * d


def support_cyl(d, p, R, radius, halflen):
    """The cylinder's support point: the cap along sign(d . a), the rim point
    along d's radial part (the cap's center when d is along the axis)."""
    a = R[..., :, 2]
    da = _dot(d, a)
    radial = d - da[..., None] * a
    nr = _norm(radial, keepdim=True)
    rdir = torch.where(nr > 1e-12, radial / torch.clamp_min(nr, 1e-12), 0.0)
    return p + (torch.sign(da) * halflen)[..., None] * a + radius[..., None] * rdir


def vecmat(x, y):
    """x (..., K) @ y (..., K, M) -> (..., M), y's leading dims broadcasting
    against x's. The axes of x along which y has size 1 ride as the rows of
    one batched product, so y is never expanded: a hull's vertices (..., V,
    3) meet a stack of directions without a copy per direction."""
    lead = torch.broadcast_shapes(x.shape[:-1], y.shape[:-2])
    n = len(lead)
    ys = (1,) * (n - (y.dim() - 2)) + tuple(y.shape[:-2])
    y = y.reshape(ys + tuple(y.shape[-2:]))
    free = [i for i in range(n) if ys[i] == 1 and lead[i] > 1]
    keep = [i for i in range(n) if i not in free]
    xk = x.expand(lead + x.shape[-1:]).permute(*keep, *free, n)
    kshape = [lead[i] for i in keep]
    xk = xk.reshape(kshape + [-1, x.shape[-1]])
    y = y[tuple(0 if i in free else slice(None) for i in range(n))]
    out = (xk @ y).reshape(kshape + [lead[i] for i in free] + [y.shape[-1]])
    order = keep + free
    return out.permute(*[order.index(i) for i in range(n)], n)


def hull_dots(d, verts):
    """d (..., 3) . each vertex of verts (..., V, 3) -> (..., V)."""
    return vecmat(d, verts.transpose(-1, -2))


def support_verts(d, verts):
    """Support point of a polytope given as its vertices (..., V, 3) along
    d (..., 3): the extreme vertex or, on a tie (a face-aligned d), the
    centroid of the vertices within 1e-12 of the extreme value."""
    vals = hull_dots(d, verts)
    w = (vals >= vals.amax(-1, keepdim=True) - 1e-12).to(d.dtype)
    return vecmat(w, verts) / torch.clamp_min(w.sum(-1, keepdim=True), 1.0)


SUPVAL_CHUNK = 2 ** 30   # products d . vertex formed at once by supval_rows


def supval_rows(u, verts):
    """max of u.x over one polytope's vertices verts (V, 3), for directions
    u (..., 3) of any shape: one product of all the directions as rows, in
    slices of at most SUPVAL_CHUNK products."""
    rows = u.reshape(-1, 3)
    step = max(1, SUPVAL_CHUNK // verts.shape[0])
    if rows.shape[0] <= step:
        return (rows @ verts.T).amax(-1).reshape(u.shape[:-1])
    out = rows.new_empty(rows.shape[0])
    for i in range(0, rows.shape[0], step):
        out[i:i + step] = (rows[i:i + step] @ verts.T).amax(-1)
    return out.reshape(u.shape[:-1])


def support_rows(u, verts, mult):
    """`support_verts` over one polytope's vertices verts (V, 3) that each
    stand for mult (V,) rows of a padded table (a pad row repeating one):
    the extreme vertex, or the mult-weighted centroid of the vertices within
    1e-12 of the extreme value. u (..., 3) of any shape."""
    vals = u.reshape(-1, 3) @ verts.T
    w = (vals >= vals.amax(-1, keepdim=True) - 1e-12).to(u.dtype) * mult
    return ((w @ verts) / torch.clamp_min(w.sum(-1, keepdim=True), 1.0)).reshape(u.shape)


def supval_verts(d, verts):
    """max of d.x over the polytope of vertices verts (..., V, 3)."""
    return hull_dots(d, verts).amax(-1)


def supval_box(d, p, R, size):
    """max of d.x over the box."""
    return _dot(d, p) + (_dotR(d, R).abs() * size).sum(-1)


def supval_cap(d, p, R, radius, halflen):
    """max of d.x over the capsule."""
    a = R[..., :, 2]
    return _dot(d, p) + halflen * _dot(d, a).abs() + radius


def supval_cyl(d, p, R, radius, halflen):
    """max of d.x over the cylinder."""
    a = R[..., :, 2]
    da = _dot(d, a)
    return _dot(d, p) + halflen * da.abs() + radius * _norm(d - da[..., None] * a)


# ---------------------------------------------------------------------------------
# clip helpers (witness selection): pt (..., 3); poses broadcast like supports
# ---------------------------------------------------------------------------------

def clip_into_box(pt, p, R, size):
    local = torch.clamp(_dotR(pt - p, R), -size, size)
    return p + _dotRT(local, R)


def clip_into_cap(pt, p, R, radius, halflen):
    a = R[..., :, 2]
    ax = torch.clamp(_dot(pt - p, a), -halflen, halflen)
    axis_pt = p + ax[..., None] * a
    off = pt - axis_pt
    on = _norm(off, keepdim=True)
    return axis_pt + off * (torch.minimum(on, radius[..., None])
                            / torch.clamp_min(on, 1e-12))


def clip_into_cyl(pt, p, R, radius, halflen):
    a = R[..., :, 2]
    rel = pt - p
    ra = _dot(rel, a)
    ax = torch.clamp(ra, -halflen, halflen)
    rad = rel - ra[..., None] * a
    rn = _norm(rad, keepdim=True)
    rad = rad * (torch.minimum(rn, radius[..., None]) / torch.clamp_min(rn, 1e-12))
    return p + ax[..., None] * a + rad


def clip_into_hull(pt, verts, iters=12, support=None):
    """Project pt (..., 3) into the convex hull of verts (..., V, 3) by
    Frank-Wolfe with exact line search on |pt - x|^2 from the vertices'
    mean: each of `iters` steps moves toward the support vertex along the
    residual (interior points stay put). `support(g)` gives the hull's
    support points along directions g (..., 3) (`support_verts` over verts
    without it)."""
    if support is None:
        support = lambda g: support_verts(g, verts)   # noqa: E731
    x = verts.mean(-2).expand(pt.shape)
    for _ in range(iters):
        g = pt - x
        dx = support(g) - x
        gamma = torch.clamp(_dot(g, dx) / torch.clamp_min(_dot(dx, dx), 1e-30), 0.0, 1.0)
        x = x + gamma[..., None] * dx
    return x


def top3_vertices(verts, vals, tol):
    """The 3 vertices of largest vals (..., V) of verts (..., V, 3), the
    first index first among equal values: the support feature triangle
    (vertex, edge or face). A vertex not within tol of the largest value is
    replaced by the first. Returns (..., 3, 3)."""
    lead = torch.broadcast_shapes(vals.shape[:-1], verts.shape[:-2])
    verts, vals = verts.expand(lead + verts.shape[-2:]), vals.expand(lead + vals.shape[-1:])
    best = vals.amax(-1, keepdim=True)
    v, pts, ok = vals, [], []
    for _ in range(3):
        i = v.argmax(-1, keepdim=True)                     # the first of the largest
        pts.append(torch.take_along_dim(verts, i[..., None], dim=-2)[..., 0, :])
        ok.append(torch.take_along_dim(v, i, dim=-1) >= best - tol)
        v = v.scatter(-1, i, -torch.inf)
    pts, ok = torch.stack(pts, -2), torch.stack(ok, -2)
    return torch.where(ok, pts, pts[..., :1, :])


def hull_face(d, verts, tol=1e-6):
    """The support feature triangle (..., 3, 3) of the hull verts (..., V,
    3) along d (..., 3): `top3_vertices` within tol."""
    return top3_vertices(verts, hull_dots(d, verts), tol)


def clip_face_box(pt, p, R, size, mask, sgn):
    """Project pt onto a support face of the box: local coordinates where
    `mask` is set are pinned to sgn*size, the others clamped into the box."""
    q = _dotR(pt - p, R)
    pinned = torch.where(mask, sgn * size, torch.clamp(q, -size, size))
    return p + _dotRT(pinned, R)


def box_face(d, R):
    """(mask, sgn) of the box support face along direction d."""
    dl = _dotR(d, R)
    return dl.abs() > _FACE_TOL, torch.sign(dl)


def clip_face_cap(pt, p, R, radius, halflen, mask_ax, sgn_ax, d):
    """Project pt onto a support face of the capsule along d: the sphere
    offset radius*d from the (pinned or clamped) axis point."""
    a = R[..., :, 2]
    da = _dot(d, a)
    t = _dot(pt - p, a) - radius * da
    ax = torch.where(mask_ax, sgn_ax * halflen, torch.clamp(t, -halflen, halflen))
    return p + ax[..., None] * a + radius[..., None] * d


def cap_face(d, R):
    """(mask_ax, sgn_ax) of the capsule support face along d."""
    da = _dot(d, R[..., :, 2])
    return da.abs() > _FACE_TOL, torch.sign(da)


def clip_face_cyl(pt, p, R, radius, halflen, mask_ax, sgn_ax, mask_rad, d):
    """Project pt onto a support face of the cylinder along d: the axial
    coordinate pinned to sgn_ax*halflen where `mask_ax` is set, else
    clamped; the radial part pinned to the rim along d's radial direction
    where `mask_rad` is set, else clamped into the disc."""
    a = R[..., :, 2]
    da = _dot(d, a)
    rel = pt - p
    ra = _dot(rel, a)
    ax = torch.where(mask_ax, sgn_ax * halflen, torch.clamp(ra, -halflen, halflen))
    dperp = d - da[..., None] * a
    npr = _norm(dperp, keepdim=True)
    rad_pin = radius[..., None] * dperp / torch.clamp_min(npr, 1e-12)
    rperp = rel - ra[..., None] * a
    rn = _norm(rperp, keepdim=True)
    rad_free = rperp * (torch.minimum(rn, radius[..., None]) / torch.clamp_min(rn, 1e-12))
    return p + ax[..., None] * a + torch.where(mask_rad, rad_pin, rad_free)


def cyl_face(d, R):
    """(mask_ax, sgn_ax, mask_rad (..., 1)) of the cylinder support face
    along d."""
    a = R[..., :, 2]
    da = _dot(d, a)
    npr = _norm(d - da[..., None] * a, keepdim=True)
    return da.abs() > _FACE_TOL, torch.sign(da), npr > _FACE_TOL


def clip_onto_triangle(pt, a, b, c):
    """Closest point of the triangle (a, b, c) to pt, all (..., 3), by the
    barycentric region decomposition: the clamped face point, overridden
    in turn by edge ab, ac, bc and vertex a, b, c where their regions hold.
    Degenerate denominators are kept at 1e-30 (physics/collision.py's
    `_closest_point_triangle` swaps an exact 0 for 1 instead, with the
    regions in another order: the two are kept apart)."""
    ab, ac, ap = b - a, c - a, pt - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = pt - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = pt - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, 1e-30)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    out = a + v[..., None] * ab + w[..., None] * ac
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, 1e-30), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, 1e-30), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-30), 0.0, 1.0)
    regions = (((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab),
               ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac),
               ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + t_bc[..., None] * (c - b)),
               ((d1 <= 0) & (d2 <= 0), a),
               ((d3 >= 0) & (d4 <= d3), b),
               ((d6 >= 0) & (d5 <= d6), c))
    for inside, q in regions:
        out = torch.where(inside[..., None], q, out)
    return out


def pocs(w, clip_a, clip_b):
    """3 rounds of alternating projections, then an Aitken vector
    extrapolation and one more round."""
    ws = [clip_a(clip_b(w))]
    for _ in range(2):
        ws.append(clip_a(clip_b(ws[-1])))
    d1, d2 = ws[-2] - ws[-3], ws[-1] - ws[-2]
    rho = torch.clamp(_dot(d1, d2) / torch.clamp_min(_dot(d1, d1), 1e-30), 0.0, 0.999)
    w = ws[-1] + d2 * (rho / (1.0 - rho))[..., None]
    return clip_a(clip_b(w))


def witness(n, depth, starts, face_a, face_b, vol_a, vol_b):
    """Contact position (the witness-pair midpoint) of each (possibly
    perturbed) configuration, n (..., 3) and depth (...,). The candidate
    starts are stacked on axis -2 of `starts` (..., S, 3), and the clip
    functions broadcast over that axis. Each start runs face-POCS, then
    touch-point refinement against B translated by (depth - _KAPPA) n; of
    the three routes per start (raw face point, touched face point,
    touched start) the smallest touch residual wins, the earlier start and
    route preferred by 1e-6."""
    shift = ((depth - _KAPPA)[..., None] * n)[..., None, :]

    def vol_b_shift(pt):
        return vol_b(pt - shift) + shift

    def touch(start):
        return pocs(pocs(start, vol_a, vol_b_shift), vol_a, vol_b_shift)

    w_face = pocs(starts, face_a, face_b)
    routes = (w_face, touch(w_face), touch(starts))
    resids = [_norm(w - vol_b_shift(w)) for w in routes]
    best = best_r = None
    for k in range(starts.shape[-2]):
        for w, r in zip(routes, resids):
            w2, r2 = w[..., k, :], r[..., k]
            if best is None:
                best, best_r = w2, r2
            else:
                take = r2 < best_r - 1e-6
                best = torch.where(take[..., None], w2, best)
                best_r = torch.minimum(best_r, r2)
    return best - 0.5 * shift[..., 0, :]


# ---------------------------------------------------------------------------------
# SAT and pattern refinement (depth_fn: (..., 3) directions -> (...,) depths)
# ---------------------------------------------------------------------------------

def best_axis(depth_fn, cands):
    """Minimum-depth unit direction over (..., N, 3) candidate axes, both
    signs, skipping near-zero candidates; first index on ties. Returns
    (depth (...,), direction (..., 3))."""
    nrm = _norm(cands, keepdim=True)
    units = cands / torch.clamp_min(nrm, 1e-12)
    dirs = torch.cat([units, -units], -2)
    ok = torch.cat([nrm, nrm], -2)[..., 0] > 1e-9
    depths = torch.where(ok, depth_fn(dirs), float('inf'))
    best, idx = depths.min(-1)            # the first index of the least
    return best, _take(dirs, idx)


def pattern_refine(depth_fn, d0, depth0, rounds, r0=0.35):
    """Pattern search for the least depth over the unit sphere: each round
    tries 8 ring directions, grows the radius x1.5 (at most r0) on
    improvement and halves it on failure. A fixed number of rounds."""
    best, bd = depth0, d0
    rad = torch.full_like(depth0, r0)
    s = 0.70710678
    for _ in range(rounds):
        t1, t2 = tangents(bd)
        ring = torch.stack([t1, -t1, t2, -t2, (t1 + t2) * s, (t1 - t2) * s,
                            (-t1 + t2) * s, (-t1 - t2) * s], -2)
        dirs = bd[..., None, :] + rad[..., None, None] * ring
        dirs = dirs / _norm(dirs, keepdim=True)
        depths = depth_fn(dirs)
        v, idx = depths.min(-1)
        cand = _take(dirs, idx)
        take = v < best
        bd = torch.where(take[..., None], cand, bd)
        best = torch.where(take, v, best)
        rad = torch.where(take, torch.clamp_max(rad * 1.5, r0), rad * 0.5)
    return best, bd


def snap_polish(depth_fn, depth, d, axes):
    """Canonicalize a refined direction onto the tie manifold it
    approximates. axes (..., A, 3): unit feature axes of the pair.
    Candidates: d with all near-zero axis components zeroed, d with each
    zeroed alone, and d aligned to each near-parallel axis; the first
    within 1e-12 of the best is taken when it is no worse than depth +
    1e-12. Returns (depth, d)."""
    dots = (d[..., None, :] * axes).sum(-1)                        # (..., A)
    small = (dots.abs() < _SNAP)[..., None]
    allz = d - torch.where(small, dots[..., None] * axes, 0.0).sum(-2)
    zero_c = torch.where(small, d[..., None, :] - dots[..., None] * axes, d[..., None, :])
    near = (dots.abs() > 1.0 - 1e-4)[..., None]
    align_c = torch.where(near, torch.sign(dots)[..., None] * axes, d[..., None, :])
    cands = torch.cat([allz[..., None, :], zero_c, align_c], -2)
    cands = cands / torch.clamp_min(_norm(cands, keepdim=True), 1e-12)
    vals = depth_fn(cands)
    v = vals.min(-1).values
    dc = _take(cands, _first_true(vals <= v[..., None] + 1e-12))
    take = v <= depth + 1e-12
    return (torch.where(take, torch.minimum(v, depth), depth),
            torch.where(take[..., None], dc, d))


# ---------------------------------------------------------------------------------
# multiccd manifold assembly
# ---------------------------------------------------------------------------------

def manifold_from_perturbed(depth0, n0, depth_p, pos_p, n_p, margin=None, pos0=None):
    """The 5-slot multiccd manifold from the 4 perturbed re-solves.

    depth0 (...,), n0 (..., 3): the unperturbed depth (> 0 penetrating) and
    direction; depth_p (..., 4), pos_p and n_p (..., 4, 3): the perturbed
    depths, witness midpoints and normals. A perturbed contact exists when
    its configuration still penetrates, or with `margin` (broadcasting
    against depth0) when it is deeper than -margin (the mesh pairs: MuJoCo
    emits their manifolds in the margin shell). Contact 0 sits at the mean
    of the valid perturbed witnesses, or at `pos0` (..., 3) where given
    (and then exists when depth0 > -margin), with normal n0. All five share
    dist = -depth0; contact k is dropped when within _DEDUP of an earlier
    kept one. Returns (dist (..., 5), pos (..., 5, 3), n (..., 5, 3)),
    dropped slots at dist 1e6."""
    valid = depth_p > 0.0 if margin is None else depth_p > -margin[..., None]
    if pos0 is None:
        wsum = torch.clamp_min(valid.to(pos_p.dtype).sum(-1), 1.0)
        pos0 = torch.where(valid[..., None], pos_p, 0.0).sum(-2) / wsum[..., None]
        any_valid = valid.any(-1, keepdim=True)
    else:
        any_valid = (depth0 > (0.0 if margin is None else -margin))[..., None]
    keep = torch.cat([any_valid, valid], -1)
    pos = torch.cat([pos0[..., None, :], pos_p], -2)
    nrm = torch.cat([n0[..., None, :], n_p], -2)
    kept = [keep[..., 0]]
    for k in range(1, 5):
        dup = torch.zeros_like(kept[0])
        for j in range(k):
            close = _norm(pos[..., k, :] - pos[..., j, :]) <= _DEDUP
            dup = dup | (kept[j] & close)
        kept.append(keep[..., k] & ~dup)
    dist = torch.where(torch.stack(kept, -1), -depth0[..., None], 1e6)
    return dist, pos, nrm
