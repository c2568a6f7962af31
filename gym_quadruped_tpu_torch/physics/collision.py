"""Narrow phase, batched over envs: robot primitives against world geoms in
fixed contact slots.

Counterpart of gym_quadruped_tpu/physics/collision.py (MuJoCo's
mj_collision). The candidate pairs are static (Model.contact_pairs); every
pair owns a fixed number of slots, always computed and masked later by
`dist < margin`. The contact normal points from geom1 (world) to geom2
(robot); `dist` is the signed separation (negative = penetration) and `pos`
the midpoint.

Ported pair groups: every type of the layout. Plane against sphere,
capsule, cylinder, box and mesh; world box against sphere and capsule; the
heightfield against sphere (the sphere against the triangles of the cells
under it), capsule (its end spheres and 5 interior samples), box, cylinder
and mesh (one CCD contact per triangular prism of the footprint, plus 4
local samples); sphere-sphere, sphere-capsule, sphere-cylinder, sphere-box,
capsule-capsule, capsule-cylinder and cylinder-cylinder (both as capsule
pairs, the reference's approximation), capsule-box and cylinder-box (the
CCD of physics/ccd.py), box-box, and the convex mesh hulls against a sphere,
a box and one another (physics/ccd.py's hull support): every compiled
robot and scene.
The slot layout (`contact_layout`) covers every pair type of the reference,
so the static tables agree for every model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_HFIELD,
    GEOM_MESH,
    GEOM_PLANE,
    GEOM_SPHERE,
    DeviceModel,
    Model,
)
from gym_quadruped_tpu_torch.physics import ccd


# ---------------------------------------------------------------------------------
# static contact layout
# ---------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairSpec:
    """Static description of one candidate pair's contact slots + combined params."""

    geom1: int           # world geom
    geom2: int           # robot geom
    ncon: int            # number of contact slots
    condim: int
    friction: tuple      # length 5: (t, t, torsion, roll, roll)
    solref: tuple        # (2,)
    solimp: tuple        # (5,)
    margin: float
    gap: float


def _combine_params(m: Model, g1: int, g2: int) -> tuple:
    """MuJoCo's contact parameter combination (priority / solmix / max rules).
    The pair margin is the sum of both geoms' margins."""
    p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
    margin = float(m.geom_margin[g1]) + float(m.geom_margin[g2])
    gap = max(float(m.geom_gap[g1]), float(m.geom_gap[g2]))
    if p1 != p2:
        g = g1 if p1 > p2 else g2
        condim = int(m.geom_condim[g])
        fri3 = m.geom_friction[g]
        solref = m.geom_solref[g]
        solimp = m.geom_solimp[g]
    else:
        condim = int(max(m.geom_condim[g1], m.geom_condim[g2]))
        fri3 = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
        s1, s2 = float(m.geom_solmix[g1]), float(m.geom_solmix[g2])
        if s1 > 0 and s2 > 0:
            mix = s1 / (s1 + s2)
        elif s1 == 0 and s2 == 0:
            mix = 0.5
        else:
            mix = 1.0 if s1 > 0 else 0.0
        r1, r2 = m.geom_solref[g1], m.geom_solref[g2]
        if r1[0] > 0 and r2[0] > 0:
            solref = mix * r1 + (1 - mix) * r2
        else:
            solref = np.minimum(r1, r2)
        solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
    friction = (float(fri3[0]), float(fri3[0]), float(fri3[1]),
                float(fri3[2]), float(fri3[2]))
    return condim, friction, tuple(float(x) for x in solref), \
        tuple(float(x) for x in solimp), margin, gap


# Slots per pair type, as in the reference (its hfield convex pipeline keeps
# the 8 deepest prisms, plus 4 local samples).
_HF_CONVEX_K = 8

_NCON_TABLE = {
    # world (geom1) vs robot (geom2)
    (GEOM_PLANE, GEOM_MESH): 3,
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_PLANE, GEOM_CYLINDER): 3,
    (GEOM_BOX, GEOM_SPHERE): 1,
    (GEOM_BOX, GEOM_CAPSULE): 5,
    (GEOM_HFIELD, GEOM_SPHERE): 8,
    (GEOM_HFIELD, GEOM_CAPSULE): 16 + 5,
    (GEOM_HFIELD, GEOM_BOX): _HF_CONVEX_K + 4,
    (GEOM_HFIELD, GEOM_CYLINDER): _HF_CONVEX_K + 4,
    (GEOM_HFIELD, GEOM_MESH): _HF_CONVEX_K + 4,
    (GEOM_BOX, GEOM_MESH): 5,
    # robot-robot (self-collision) pairs, stored with type1 <= type2
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_CYLINDER): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_CYLINDER): 1,
    (GEOM_CAPSULE, GEOM_BOX): 5,
    (GEOM_CYLINDER, GEOM_CYLINDER): 1,
    (GEOM_CYLINDER, GEOM_BOX): 5,
    (GEOM_BOX, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_MESH): 1,
    (GEOM_MESH, GEOM_MESH): 5,
}

_GEOM_NAMES = {GEOM_PLANE: 'plane', GEOM_HFIELD: 'hfield', GEOM_SPHERE: 'sphere',
               GEOM_CAPSULE: 'capsule', GEOM_CYLINDER: 'cylinder',
               GEOM_BOX: 'box', GEOM_MESH: 'mesh'}


@functools.lru_cache(maxsize=64)
def contact_layout(m: Model) -> tuple:
    """Static pair specs, grouped by (type1, type2) so each group runs as one
    batched primitive (stable order within a group)."""
    specs = []
    for g1, g2 in np.asarray(m.contact_pairs):
        t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
        ncon = _NCON_TABLE.get((t1, t2))
        if ncon is None:
            continue
        for g, t in ((g1, t1), (g2, t2)):
            if t == GEOM_MESH and (m.geom_dataid.size == 0
                                   or int(m.geom_dataid[g]) < 0):
                ncon = None  # mesh pair without hull data (older archives)
        if ncon is None:
            continue
        condim, friction, solref, solimp, margin, gap = _combine_params(m, g1, g2)
        specs.append(PairSpec(int(g1), int(g2), ncon, condim, friction,
                              solref, solimp, margin, gap))
    specs.sort(key=lambda s: (int(m.geom_type[s.geom1]),
                              int(m.geom_type[s.geom2])))
    return tuple(specs)


def total_contact_slots(m: Model) -> int:
    return sum(s.ncon for s in contact_layout(m))


def _pair_groups(m: Model):
    """[(t1, t2, g1 (G,), g2 (G,))] runs of equal pair type, in slot order."""
    specs = contact_layout(m)
    groups, i = [], 0
    while i < len(specs):
        t1 = int(m.geom_type[specs[i].geom1])
        t2 = int(m.geom_type[specs[i].geom2])
        j = i
        while j < len(specs) and int(m.geom_type[specs[j].geom1]) == t1 \
                and int(m.geom_type[specs[j].geom2]) == t2:
            j += 1
        groups.append((t1, t2, np.array([s.geom1 for s in specs[i:j]]),
                       np.array([s.geom2 for s in specs[i:j]])))
        i = j
    return groups


# ---------------------------------------------------------------------------------
# primitive tests: poses (B, G, 3) and (B, G, 3, 3), sizes (G, 3) or (G,) in;
# dist (B, G, k), pos and normal (B, G, k, 3) out, k slots per pair
# ---------------------------------------------------------------------------------

_BOX_CORNER_SIGNS = np.array(
    [[-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1]], np.float64)

_dot, _cross, _norm = ccd._dot, ccd._cross, ccd._norm


def _deepest_k(d, pos, n, k):
    """The k smallest-dist candidates of d (..., c), pos and n (..., c, 3),
    in ascending order, the first index first among equal distances."""
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    take = lambda x: torch.take_along_dim(x, idx[..., None], dim=-2)
    return torch.take_along_dim(d, idx, dim=-1), take(pos), take(n)


def _plane_sphere(ppos, pmat, center, radius):
    n = pmat[..., :, 2]
    d = _dot(n, center - ppos) - radius
    pos = center - n * (radius + 0.5 * d)[..., None]
    return d[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(ppos, pmat, cpos, cmat, radius, halflen):
    """Both end spheres of the capsule against the plane."""
    n = pmat[..., :, 2]
    axis = cmat[..., :, 2] * halflen[:, None]
    ends = torch.stack([cpos + axis, cpos - axis], -2)             # (B, G, 2, 3)
    d = _dot(n[..., None, :], ends - ppos[..., None, :]) - radius[:, None]
    pos = ends - n[..., None, :] * (radius[:, None] + 0.5 * d)[..., None]
    return d, pos, n[..., None, :].expand_as(pos)


def _plane_cylinder(ppos, pmat, cpos, cmat, radius, halflen):
    """3 points against the plane: on each cap's rim the point nearest the
    plane, then the center lowered by the caps' reach along the normal
    (exact when the cylinder rests flat or on a rim edge). An upright
    cylinder has no rim direction and takes the plane's x axis."""
    n = pmat[..., :, 2]
    axis = cmat[..., :, 2]
    proj = -n + axis * _dot(axis, n)[..., None]       # -n without its axial part
    norm = _norm(proj)
    safe = torch.where((norm > 1e-10)[..., None],
                       proj / torch.clamp_min(norm, 1e-10)[..., None], pmat[..., :, 0])
    h = halflen[:, None]
    rims = torch.stack([cpos + axis * h, cpos + axis * -h], -2) \
        + safe[..., None, :] * radius[:, None, None]                 # (B, G, 2, 3)
    d_rim = _dot(n[..., None, :], rims - ppos[..., None, :])
    # the reference's `- |proj| 0` term, kept for its arithmetic
    dc = _dot(n, cpos - ppos) - _dot(n, axis).abs() * halflen - norm * 0.0
    d = torch.cat([d_rim, dc[..., None]], -1)
    pts = torch.cat([rims, cpos[..., None, :]], -2)
    pos = pts - (0.5 * d)[..., None] * n[..., None, :]
    return d, pos, n[..., None, :].expand_as(pos)


def _box_corners(p, R, size, signs):
    """(..., 8, 3) world corners of boxes p (..., 3), R (..., 3, 3) with
    sizes (..., 3) that broadcast against them, in the order of `signs`
    (8, 3)."""
    local = signs * size[..., None, :]                             # (..., 8, 3)
    return p[..., None, :] + (R[..., None, :, :] * local[..., None, :]).sum(-1)


def _plane_box(ppos, pmat, bpos, bmat, size, signs):
    """The 4 deepest of the box's 8 corners against the plane."""
    n = pmat[..., :, 2]
    d_axis = ccd._dotR(n, bmat) * size                             # (B, G, 3)
    center_d = _dot(n, bpos - ppos)
    depths = center_d[..., None] + (signs * d_axis[..., None, :]).sum(-1)   # (B, G, 8)
    corners = _box_corners(bpos, bmat, size, signs)
    d4, c4, _ = _deepest_k(depths, corners, corners, 4)
    pos = c4 - 0.5 * d4[..., None] * n[..., None, :]
    return d4, pos, n[..., None, :].expand_as(pos)


def _points_in_box_local(local, size):
    """Points (..., 3) in a box's local frame against the box (size
    broadcasting against them): (dist, surface point, outward local normal).
    A point inside leaves along the axis of least depth, the first axis on
    ties."""
    clamped = torch.clamp(local, -size, size)
    delta = local - clamped
    dist_out = _norm(delta)
    inside = dist_out < 1e-12
    depth = size - local.abs()
    dmin = depth.min(-1).values
    e0, e1, e2 = (depth == dmin[..., None]).unbind(-1)
    first = torch.stack([e0, e1 & ~e0, e2 & ~(e0 | e1)], -1)
    sign = torch.where(local >= 0, 1.0, -1.0).to(local.dtype)
    n_in = first.to(local.dtype) * sign
    surf_in = torch.where(first, sign * size, local)
    n_out = delta / torch.clamp_min(dist_out, 1e-12)[..., None]
    n_local = torch.where(inside[..., None], n_in, n_out)
    surf = torch.where(inside[..., None], surf_in, clamped)
    d = torch.where(inside, -dmin, dist_out)
    return d, surf, n_local


def _box_sphere(bpos, bmat, size, center, radius):
    """Sphere against box by the closest point, normal box -> sphere."""
    local = ccd._dotR(center - bpos, bmat)
    d, surf, n_local = _points_in_box_local(local, size)
    d = d - radius
    n = ccd._dotRT(n_local, bmat)
    pos = ccd._dotRT(surf, bmat) + bpos + 0.5 * d[..., None] * n
    return d[..., None], pos[..., None, :], n[..., None, :]


def _sphere_sphere(p1, r1, p2, r2, up):
    d12 = p2 - p1
    dlen = _norm(d12)
    n = torch.where((dlen > 1e-12)[..., None],
                    d12 / torch.clamp_min(dlen, 1e-12)[..., None], up)
    dist = dlen - r1 - r2
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _closest_on_segment(p, a, b):
    ab = b - a
    t = torch.clamp(_dot(p - a, ab) / torch.clamp_min(_dot(ab, ab), 1e-30), 0.0, 1.0)
    return a + t[..., None] * ab


def _sphere_capsule(c, r_s, cpos, cmat, r_c, halflen, up):
    axis = cmat[..., :, 2] * halflen[:, None]
    q = _closest_on_segment(c, cpos - axis, cpos + axis)
    return _sphere_sphere(c, r_s, q, r_c, up)


def _sphere_cylinder(c, r_s, cpos, cmat, R_c, halflen):
    """Sphere against the solid cylinder by the closest point of its surface
    (side, cap or rim); a center inside leaves by the nearer of the side
    (strictly nearer) and the cap on sign(a)'s side. Normal sphere ->
    cylinder."""
    axis = cmat[..., :, 2]
    rel = c - cpos
    a = _dot(rel, axis)                                # axial coordinate
    radial = rel - a[..., None] * axis
    rlen = _norm(radial)
    rdir = torch.where((rlen > 1e-12)[..., None],
                       radial / torch.clamp_min(rlen, 1e-12)[..., None], cmat[..., :, 0])
    a_cl = torch.clamp(a, -halflen, halflen)
    r_cl = torch.minimum(rlen, R_c)
    inside = (a.abs() < halflen) & (rlen < R_c)
    q_out = cpos + axis * a_cl[..., None] + rdir * r_cl[..., None]
    d_side = R_c - rlen
    d_cap = halflen - a.abs()
    q_side = cpos + axis * a[..., None] + rdir * R_c[:, None]
    q_cap = cpos + axis * (torch.sign(a) * halflen)[..., None] + rdir * rlen[..., None]
    q_in = torch.where((d_side < d_cap)[..., None], q_side, q_cap)
    q = torch.where(inside[..., None], q_in, q_out)
    dvec = c - q
    dlen = _norm(dvec)
    far = (dlen > 1e-12)[..., None]
    unit = dvec / torch.clamp_min(dlen, 1e-12)[..., None]
    n_out = torch.where(far, -dvec / torch.clamp_min(dlen, 1e-12)[..., None], -axis)
    n_in = torch.where(far, unit, axis)
    n = torch.where(inside[..., None], n_in, n_out)
    dist = torch.where(inside, -(dlen + r_s), dlen - r_s)
    pos = c + n * (r_s + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _segment_segment(a1, b1, a2, b2):
    """Closest points between segments (a1, b1) and (a2, b2) (Ericson
    5.1.9: s from the unclamped solution, t from s, then s again when t
    was clamped)."""
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-14, torch.clamp(
        (b * f - c * e) / torch.clamp_min(denom, 1e-14), 0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp_min(e, 1e-30)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(t != t_cl,
                    torch.clamp((t_cl * b - c) / torch.clamp_min(a, 1e-30), 0.0, 1.0), s)
    return a1 + d1 * s[..., None], a2 + d2 * t_cl[..., None]


def _capsule_capsule(p1, R1, r1, h1, p2, R2, r2, h2, up):
    ax1 = R1[..., :, 2] * h1[:, None]
    ax2 = R2[..., :, 2] * h2[:, None]
    q1, q2 = _segment_segment(p1 - ax1, p1 + ax1, p2 - ax2, p2 + ax2)
    return _sphere_sphere(q1, r1, q2, r2, up)


def _box_box(p1, R1, s1, p2, R2, s2, signs):
    """Box against box: 17 candidates, of which the 4 deepest are kept.

    16 corner-in-box tests (box 2's corners in box 1, normal outward of box
    1; box 1's corners in box 2, normal negated) and one edge-edge
    candidate: the SAT minimum over the 9 edge cross axes, whose support
    edges give the closest-point contact. The edge candidate is dropped
    (dist 1e9) when the boxes are separated along any axis, when a
    penetrating corner candidate lies within 2 mm of it, or when its depth
    exceeds the least face overlap."""
    big = 1e9
    # ---- corners: side 0 tests box 2's corners in box 1, side 1 the reverse
    Pa, Ra = torch.stack([p1, p2], -2), torch.stack([R1, R2], -3)   # (B, G, 2, ...)
    Pb, Rb = torch.stack([p2, p1], -2), torch.stack([R2, R1], -3)
    Sa, Sb = torch.stack([s1, s2], -2), torch.stack([s2, s1], -2)   # (G, 2, 3)
    cw = _box_corners(Pb, Rb, Sb, signs)                           # (B, G, 2, 8, 3)
    loc = ccd._dotR(cw - Pa[..., None, :], Ra[..., None, :, :])
    d_c, sl, nl = _points_in_box_local(loc, Sa[..., None, :])
    pw = ccd._dotRT(sl + 0.5 * d_c[..., None] * nl, Ra[..., None, :, :]) + Pa[..., None, :]
    nw = ccd._dotRT(nl, Ra[..., None, :, :])
    nw = torch.cat([nw[..., :1, :, :], -nw[..., 1:, :, :]], -3)
    shp = d_c.shape[:-2] + (16,)
    d_c, pw, nw = d_c.reshape(shp), pw.reshape(shp + (3,)), nw.reshape(shp + (3,))

    # ---- edge-edge: SAT over the 6 face axes and the 9 cross axes
    T = p2 - p1
    ax1, ax2 = R1.transpose(-1, -2), R2.transpose(-1, -2)          # rows = box axes

    def overlap(L):   # L (B, G, ..., 3)
        e = L.dim() - 3
        A1 = ax1[(...,) + (None,) * e + (slice(None),) * 2]
        A2 = ax2[(...,) + (None,) * e + (slice(None),) * 2]
        S1 = s1[(slice(None),) + (None,) * e + (slice(None),)]
        S2 = s2[(slice(None),) + (None,) * e + (slice(None),)]
        Te = T[(...,) + (None,) * e + (slice(None),)]
        r1 = (S1 * (A1 * L[..., None, :]).sum(-1).abs()).sum(-1)
        r2 = (S2 * (A2 * L[..., None, :]).sum(-1).abs()).sum(-1)
        return r1 + r2 - _dot(Te, L).abs()

    ov = overlap(torch.cat([ax1, ax2], -2))                        # (B, G, 6)
    sep_face = (-ov).max(-1).values
    min_face = ov.min(-1).values

    L = _cross(ax1[..., :, None, :], ax2[..., None, :, :]).flatten(-3, -2)   # (B, G, 9, 3)
    nl_ = torch.sqrt(torch.clamp_min(_dot(L, L), 1e-30))
    ok = nl_ > 1e-8
    Lu = L / nl_[..., None]
    st = torch.where(_dot(T[..., None, :], Lu) >= 0, 1.0, -1.0).to(L.dtype)
    Lu = st[..., None] * Lu
    dep = overlap(Lu)                                              # (B, G, 9)
    sep = torch.maximum(sep_face, torch.where(ok, -dep, -big).max(-1).values)
    # support edges: box 1's corner extreme along +Lu on its other two
    # axes, box 2's along -Lu
    j1 = torch.arange(3, device=L.device).repeat_interleave(3)     # cross axis k = 3 j1 + j2
    j2 = torch.arange(3, device=L.device).repeat(3)
    kk = torch.arange(3, device=L.device)
    other1 = (kk[None, :] != j1[:, None]).to(L.dtype)              # (9, 3)
    other2 = (kk[None, :] != j2[:, None]).to(L.dtype)
    g1 = (ax1[..., None, :, :] * Lu[..., None, :]).sum(-1)         # (B, G, 9, 3)
    g2 = (ax2[..., None, :, :] * Lu[..., None, :]).sum(-1)
    sg1 = torch.where(g1 >= 0, 1.0, -1.0).to(L.dtype) * other1 * s1[:, None, :]
    sg2 = torch.where(g2 >= 0, -1.0, 1.0).to(L.dtype) * other2 * s2[:, None, :]
    c1 = p1[..., None, :] + (sg1[..., None] * ax1[..., None, :, :]).sum(-2)
    c2 = p2[..., None, :] + (sg2[..., None] * ax2[..., None, :, :]).sum(-2)
    u, v = ax1[..., j1, :], ax2[..., j2, :]                        # (B, G, 9, 3)
    h1, h2 = s1[:, j1], s2[:, j2]                                  # (G, 9)
    w0 = c1 - c2
    b_uv = _dot(u, v)
    d_u = _dot(u, w0)
    d_v = _dot(v, w0)
    den = torch.clamp_min(1.0 - b_uv * b_uv, 1e-12)
    t_u = torch.clamp((b_uv * d_v - d_u) / den, -h1, h1)
    # -d_v as in the reference (the closest point on v is d_v + t_u b_uv):
    # kept for parity, it moves only this candidate's pos
    t_v = torch.clamp(t_u * b_uv - d_v, -h2, h2)
    t_u = torch.clamp(t_v * b_uv - d_u, -h1, h1)
    mid = 0.5 * ((c1 + t_u[..., None] * u) + (c2 + t_v[..., None] * v))
    d_e = torch.where(ok, -dep, big)
    best_d, best = d_e.min(-1)                                     # first index on ties
    mid, Lu = ccd._take(mid, best), ccd._take(Lu, best)
    near_corner = ((((pw - mid[..., None, :]) ** 2).sum(-1) < 4e-6) & (d_c < 0)).any(-1)
    d_edge = torch.where((sep > 0) | near_corner | (-best_d > min_face), big, best_d)

    d = torch.cat([d_c, d_edge[..., None]], -1)
    pos = torch.cat([pw, mid[..., None, :]], -2)
    n = torch.cat([nw, Lu[..., None, :]], -2)
    return _deepest_k(d, pos, n, 4)


class _Shape(NamedTuple):
    """The support, face and clip functions of a convex geom of the CCD
    (ccd.py), each taking (p, R, *sizes) after the direction or point;
    `face(d, p, R, *sizes)` gives the tuple that `clip_face` takes before
    d."""

    supval: Callable
    support: Callable
    face: Callable
    clip_face: Callable
    clip_into: Callable


_CAPSULE = _Shape(ccd.supval_cap, ccd.support_cap, lambda d, p, R, *dims: ccd.cap_face(d, R),
                  ccd.clip_face_cap, ccd.clip_into_cap)
_CYLINDER = _Shape(ccd.supval_cyl, ccd.support_cyl, lambda d, p, R, *dims: ccd.cyl_face(d, R),
                   ccd.clip_face_cyl, ccd.clip_into_cyl)
_BOX = _Shape(ccd.supval_box, ccd.support_box, lambda d, p, R, size: ccd.box_face(d, R),
              lambda pt, p, R, size, mask, sgn, d: ccd.clip_face_box(pt, p, R, size, mask, sgn),
              ccd.clip_into_box)


def _hull_local(p, R, V):
    """The hulls' vertices V (G, Vmax, 3) at the poses p (B, G, ..., 3), R
    (B, G, ..., 3, 3): V R' + p, (B, G, ..., Vmax, 3)."""
    V = V.reshape(V.shape[:1] + (1,) * (p.dim() - 3) + V.shape[1:])
    return V @ R.transpose(-1, -2) + p[..., None, :]


class HullSet(NamedTuple):
    """The convex hulls of one side of a mesh group's G pairs: their
    vertices padded to the model's largest hull (G, Vmax, 3), in the geom
    frame, and the same split by distinct hull: (the pairs that use it
    (G_h,), or None for all G, its own vertices (V_h, 3), how many rows of
    the padded table each stands for (V_h,)). A support value over the
    pairs of one hull runs as one product of all their directions with its
    own vertices (no pad rows, no batch of tiny products)."""

    padded: torch.Tensor
    hulls: tuple

    def split(self, u, fn):
        """fn(directions, hull vertices, multiplicities) over the pairs of
        each hull: u (B, G, ..., k), the pair axis 1; results keep u's
        leading shape."""
        out = None
        for idx, verts, mult in self.hulls:
            part = fn(u if idx is None else u.index_select(1, idx), verts, mult)
            if idx is None:
                return part
            if out is None:
                out = part.new_empty(u.shape[:2] + part.shape[2:])
            out.index_copy_(1, idx, part)
        return out

    def supval(self, u):
        """max of u.x over each pair's hull, u (B, G, ..., 3) local."""
        return self.split(u, lambda x, V, mult: ccd.supval_rows(x, V))

    def support(self, u):
        """`ccd.support_verts` over each pair's padded hull, u (B, G, ..., 3)
        local."""
        return self.split(u, ccd.support_rows)


def _hull_supval(d, p, R, hs: HullSet):
    """max of d.x over each pair's hull at the pose (p, R): d.p + the support
    value of the direction in the geom frame."""
    return _dot(d, p) + hs.supval(ccd._dotR(d, R))


def _clip_into_hull(pt, p, R, hs: HullSet):
    """`ccd.clip_into_hull` of pt into each pair's hull at the pose (p, R),
    its support points taken in the geom frame."""
    return ccd.clip_into_hull(pt, _hull_local(p, R, hs.padded),
                              support=lambda g: p + ccd._dotRT(hs.support(ccd._dotR(g, R)), R))


# A convex mesh as a CCD geom: its `HullSet` is its one size; the support
# feature is the top-3 vertex triangle (`ccd.hull_face`), and the volume clip
# Frank-Wolfe's
_HULL = _Shape(
    _hull_supval,
    lambda d, p, R, hs: p + ccd._dotRT(hs.support(ccd._dotR(d, R)), R),
    lambda d, p, R, hs: (ccd.hull_face(d, _hull_local(p, R, hs.padded)),),
    lambda pt, p, R, hs, tri, d: ccd.clip_onto_triangle(pt, tri[..., 0, :], tri[..., 1, :],
                                                        tri[..., 2, :]),
    _clip_into_hull)


def _ccd_box(shape: _Shape, p1, R1, radius, halflen, p2, R2, size, signs):
    """Capsule or cylinder (geom A, `shape`) against box (geom B) by the
    reference's decoded native-CCD + multiccd pipeline: SAT over 16
    candidate axes (the 7 box and cross axes, the axis to the box center
    and the 8 radial directions to the box corners), 16 rounds of pattern
    refinement and a snap onto the tie lattice (A's axis, B's axes); then
    the 4 perturbed configurations (8 rounds from r0 8e-3 and a snap each),
    their witnesses started with the side-line endpoint bias, and the
    5-slot manifold. radius and halflen (G,), size (G, 3). Normal A -> B."""
    rad1, hl1, size1 = radius[:, None], halflen[:, None], size[:, None, :]

    def depth_fn(d):                        # d (B, G, N, 3)
        return (shape.supval(d, p1[..., None, :], R1[..., None, :, :], rad1, hl1)
                + ccd.supval_box(-d, p2[..., None, :], R2[..., None, :, :], size1))

    a = R1[..., :, 2]
    t = torch.clamp(_dot(p2 - p1, a), -halflen, halflen)
    corners = _box_corners(p2, R2, size, signs)                    # (B, G, 8, 3)
    tc = torch.clamp(_dot(corners - p1[..., None, :], a[..., None, :]), -hl1, hl1)
    rad_corner = corners - (p1[..., None, :] + tc[..., None] * a[..., None, :])
    b0, b1, b2 = R2[..., :, 0], R2[..., :, 1], R2[..., :, 2]
    cands = torch.cat([torch.stack([
        b0, b1, b2, a, _cross(b0, a), _cross(b1, a), _cross(b2, a),
        (p1 + t[..., None] * a) - p2], -2), rad_corner], -2)       # (B, G, 16, 3)
    d0_depth, d0 = ccd.best_axis(depth_fn, cands)
    depth0, n0 = ccd.pattern_refine(depth_fn, d0, d0_depth, rounds=16)
    axes0 = torch.stack([a, b0, b1, b2], -2)
    depth0, n0 = ccd.snap_polish(depth_fn, depth0, n0, axes0)

    # the 4 perturbed configurations, on an axis of 4 after (B, G)
    Ra, Rb = ccd.perturb_rots(n0)                                  # (B, G, 4, 3, 3)
    R1p, R2p = Ra @ R1[..., None, :, :], Rb @ R2[..., None, :, :]
    p1p, p2p = p1[..., None, :], p2[..., None, :]
    rad2, hl2, size2 = radius[:, None, None], halflen[:, None, None], size[:, None, None, :]

    def depth_fn_p(d):                      # d (B, G, 4, 3) or (B, G, 4, N, 3)
        if d.dim() == 4:
            return (shape.supval(d, p1p, R1p, rad1, hl1)
                    + ccd.supval_box(-d, p2p, R2p, size1))
        return (shape.supval(d, p1p[..., None, :], R1p[..., None, :, :], rad2, hl2)
                + ccd.supval_box(-d, p2p[..., None, :], R2p[..., None, :, :], size2))

    n0b = n0[..., None, :].expand(n0.shape[:-1] + (4, 3))
    depth_p, n_p = ccd.pattern_refine(depth_fn_p, n0b, depth_fn_p(n0b), rounds=8, r0=8e-3)
    axes_p = torch.cat([R1p[..., :, 2][..., None, :], R2p.transpose(-1, -2)], -2)
    depth_p, n_p = ccd.snap_polish(depth_fn_p, depth_p, n_p, axes_p)
    xa = shape.support(n_p, p1p, R1p, rad1, hl1)
    xb = ccd.support_box(-n_p, p2p, R2p, size1)
    # endpoint bias for tie-degenerate tilts: +-(t . a) 2 halflen a per config
    t1b, t2b = ccd.tangents(n0)
    ta1, ta2 = _dot(t1b, a), _dot(t2b, a)
    bias = (torch.stack([ta1, -ta1, ta2, -ta2], -1)
            * (2.0 * hl1))[..., None] * a[..., None, :]            # (B, G, 4, 3)
    face0 = shape.face(n0, p1, R1, radius, halflen)
    f_mask, f_sgn = ccd.box_face(-n0, R2)
    w0 = ccd.pocs(
        0.5 * (shape.support(n0, p1, R1, radius, halflen)
               + ccd.support_box(-n0, p2, R2, size)),
        lambda pt: shape.clip_face(pt, p1, R1, radius, halflen, *face0, n0),
        lambda pt: ccd.clip_face_box(pt, p2, R2, size, f_mask, f_sgn))
    # the witness's 2 starts stacked on an axis after the 4 configurations
    u = lambda x: x.unsqueeze(3)
    face_p = [u(f) for f in shape.face(n_p, p1p, R1p, rad1, hl1)]
    bmask, bsgn = (u(f) for f in ccd.box_face(-n_p, R2p))
    p1s, R1s, p2s, R2s = u(p1p), u(R1p), u(p2p), u(R2p)
    start = 0.5 * (xa + xb) + bias
    pos_p = ccd.witness(
        n_p, depth_p, torch.stack([start, w0[..., None, :].expand_as(start)], 3),
        lambda pt: shape.clip_face(pt, p1s, R1s, rad2, hl2, *face_p, u(n_p)),
        lambda pt: ccd.clip_face_box(pt, p2s, R2s, size2, bmask, bsgn),
        lambda pt: shape.clip_into(pt, p1s, R1s, rad2, hl2),
        lambda pt: ccd.clip_into_box(pt, p2s, R2s, size2))
    return ccd.manifold_from_perturbed(depth0, n0, depth_p, pos_p, n_p)


# ---------------------------------------------------------------------------------
# mesh pairs: convex hulls given by their vertices V (G, Vmax, 3) in the geom
# frame, padded to the model's largest hull (pads are the geom's origin, an
# interior point, where a hull's support is taken over every row)
# ---------------------------------------------------------------------------------

_MESH_EPS = 1.75e-3   # the mesh pairs' multiccd tilt


def _plane_mesh(ppos, pmat, gpos, gmat, verts, nbr, nvert, rbound, margin):
    """Plane against a convex mesh hull, MuJoCo's mjc_PlaneConvex as the
    reference decoded it: contact 0 at the support vertex along -n (the
    first on ties), its position shifted to half depth; then up to 2 of its
    hull-graph neighbours (nbr (G, Vmax, D), -1 padded), in adjacency
    order, each taken when closer than margin to the plane and at least 0.3
    rbound from contact 0's position. nvert (G,) live rows (pads at 1e9),
    rbound and margin (G,). 3 slots, dropped ones at 1e9."""
    n = pmat[..., :, 2]                                                # (B, G, 3)
    W = _hull_local(gpos, gmat, verts)                                 # (B, G, V, 3)
    pad = torch.arange(verts.shape[-2], device=W.device) >= nvert[:, None]
    d = torch.where(pad, 1e9, (W @ n[..., None])[..., 0] - _dot(n, ppos)[..., None])
    i0 = d.argmin(-1)                                                  # the first of the least
    dist0 = torch.take_along_dim(d, i0[..., None], -1)[..., 0]
    pos0 = torch.take_along_dim(W, i0[..., None, None], -2)[..., 0, :] - (0.5 * dist0)[..., None] * n
    cand = nbr[torch.arange(nbr.shape[0], device=W.device), i0]       # (B, G, D)
    safe = torch.clamp_min(cand, 0)
    dc = torch.take_along_dim(d, safe, -1)
    Wc = torch.take_along_dim(W, safe[..., None], -2)                  # (B, G, D, 3)
    far = _norm(Wc - pos0[..., None, :]) >= 0.3 * rbound[:, None]
    valid = (cand >= 0) & (dc < margin[:, None]) & far
    rank = torch.cumsum(valid.to(torch.int64), -1) - 1
    dists, poss = [dist0], [pos0]
    for k in range(2):
        sel = (valid & (rank == k)).to(d.dtype)
        got = sel.sum(-1) > 0
        dk = (sel * dc).sum(-1)
        pk = (sel[..., None] * Wc).sum(-2) - (0.5 * dk)[..., None] * n
        dists.append(torch.where(got, dk, 1e9))
        poss.append(torch.where(got[..., None], pk, pos0))
    return torch.stack(dists, -1), torch.stack(poss, -2), n[..., None, :].expand(n.shape[:-1] + (3, 3))


def _sphere_mesh(c, r, p2, R2, hs2: HullSet):
    """Sphere (geom 1) against a convex hull: the least depth over the
    sphere's support c + r n and the hull's by `ccd.best_axis` over two
    starts (the centers' axis, the vertex mean's) and 20 rounds of
    `ccd.pattern_refine`; the contact at the midpoint of the two surfaces.
    One slot."""
    W2 = _hull_local(p2, R2, hs2.padded)
    c_n, p2_n, R2_n = c[..., None, :], p2[..., None, :], R2[..., None, :, :]

    def depth_fn(d):                        # (B, G, N, 3) -> (B, G, N)
        return _dot(d, c_n) + r[:, None] + _hull_supval(-d, p2_n, R2_n, hs2)

    depth0, d0 = ccd.best_axis(depth_fn, torch.stack([p2 - c, W2.mean(-2) - c], -2))
    depth, n = ccd.pattern_refine(depth_fn, d0, depth0, rounds=20)
    dist = -depth
    pos = c + (r + 0.5 * dist)[..., None] * n
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _feature_tangent(f1, f2, rounds=8):
    """Alternating projections between two support-feature triangles (...,
    3, 3) from f1's first vertex: the tangential witness point (..., 3)."""
    tri = lambda f: (f[..., 0, :], f[..., 1, :], f[..., 2, :])
    w = f1[..., 0, :]
    for _ in range(rounds):
        w = ccd.clip_onto_triangle(w, *tri(f1))
        w = ccd.clip_onto_triangle(w, *tri(f2))
    return w


def _hull_hull_witness(W1, W2, n, tol=1e-5):
    """Witness of a hull-hull contact along the unit direction n (..., 3):
    the alternating projections between the two support features (the top
    3 vertices of each side within tol), lifted midway between the two
    support planes."""
    v1, v2 = ccd.hull_dots(n, W1), ccd.hull_dots(-n, W2)
    s1, s2 = v1.amax(-1), -v2.amax(-1)
    w = _feature_tangent(ccd.top3_vertices(W1, v1, tol), ccd.top3_vertices(W2, v2, tol))
    return w + (0.5 * (s1 + s2) - _dot(w, n))[..., None] * n


def _mesh_mesh(p1, R1, hs1: HullSet, p2, R2, hs2: HullSet, margin):
    """Convex hull against convex hull (a box as its 8 corners too) with the
    5-slot multiccd manifold, as the reference decoded MuJoCo's: depth and
    normal by `ccd.best_axis` over two starts and 48 rounds of refinement;
    contact 0 at the hull-hull witness; the 4 re-solves tilted by 1.75e-3
    (12 rounds from r0 8e-3 each, batched on an axis of 4), whose witness
    features are chosen on the tilted hulls and taken at the untilted
    vertices, lifted between the untilted support planes; existence aware
    of the margin (G,). hs1 and hs2 the two sides' `HullSet`s; poses (B,
    G, ...)."""
    W1, W2 = _hull_local(p1, R1, hs1.padded), _hull_local(p2, R2, hs2.padded)   # (B, G, V, 3)
    W1_n, W2_n = W1[..., None, :, :], W2[..., None, :, :]
    p1_n, R1_n, p2_n, R2_n = p1[..., None, :], R1[..., None, :, :], p2[..., None, :], \
        R2[..., None, :, :]

    def depth_fn(d):                        # (B, G, N, 3) -> (B, G, N)
        return _hull_supval(d, p1_n, R1_n, hs1) + _hull_supval(-d, p2_n, R2_n, hs2)

    d0_depth, d0 = ccd.best_axis(depth_fn, torch.stack([p2 - p1, W2.mean(-2) - W1.mean(-2)], -2))
    depth0, n0 = ccd.pattern_refine(depth_fn, d0, d0_depth, rounds=48)
    w0 = _hull_hull_witness(W1, W2, n0)

    Ra, Rb = ccd.perturb_rots(n0, eps=_MESH_EPS)                       # (B, G, 4, 3, 3)
    tilt = lambda W, p, Rk: ((W - p[..., None, :])[..., None, :, :] @ Rk.transpose(-1, -2)
                             + p[..., None, None, :])
    W1p, W2p = tilt(W1, p1, Ra), tilt(W2, p2, Rb)                      # (B, G, 4, V, 3)
    # the tilted hulls' support values in the geom frames: W1p = p1 + Ra R1 V1
    R1p, R2p = Ra @ R1[..., None, :, :], Rb @ R2[..., None, :, :]      # (B, G, 4, 3, 3)
    p1p, p2p = p1[..., None, :], p2[..., None, :]

    def depth_fn_p(d):                      # (B, G, 4, 3) or (B, G, 4, N, 3)
        if d.dim() == 4:
            return _hull_supval(d, p1p, R1p, hs1) + _hull_supval(-d, p2p, R2p, hs2)
        return (_hull_supval(d, p1p[..., None, :], R1p[..., None, :, :], hs1)
                + _hull_supval(-d, p2p[..., None, :], R2p[..., None, :, :], hs2))

    n0b = n0[..., None, :].expand(n0.shape[:-1] + (4, 3))
    depth_p, n_p = ccd.pattern_refine(depth_fn_p, n0b, depth_fn_p(n0b), rounds=12, r0=8e-3)
    s1 = ccd.hull_dots(n0, W1).amax(-1)
    s2 = -ccd.hull_dots(-n0, W2).amax(-1)
    f1 = ccd.top3_vertices(W1_n, ccd.hull_dots(n_p, W1p), 1e-5)
    f2 = ccd.top3_vertices(W2_n, ccd.hull_dots(-n_p, W2p), 1e-5)
    w = _feature_tangent(f1, f2)                                       # (B, G, 4, 3)
    n0k = n0[..., None, :]
    pos_p = w + (0.5 * (s1 + s2)[..., None] - _dot(w, n0k))[..., None] * n0k
    return ccd.manifold_from_perturbed(depth0, n0, depth_p, pos_p, n_p, margin=margin, pos0=w0)


# ---------------------------------------------------------------------------------
# heightfield pairs: the terrain as a grid of cells, each split along its main
# diagonal (c, r) -> (c + 1, r + 1) into two triangular prisms whose tops are
# raised by the pair margin. hpos (..., 3) and hmat (..., 3, 3) are the
# heightfield geom's pose; "local" is its frame.
# ---------------------------------------------------------------------------------

def _hf_grid(dm: DeviceModel):
    """The heightfield's size (x half, y half, z top, z bottom), rows,
    columns and its heights in [0, 1], flattened row-major."""
    m = dm.m
    return dm.hfield_size, int(m.hfield_nrow), int(m.hfield_ncol), dm.hfield_data.reshape(-1)


def _hf_corner(dm: DeviceModel, jj, ii, top):
    """(..., 3) local grid vertices at rows jj and columns ii (int64), their
    heights raised by `top` (broadcasting against jj)."""
    sz, nr, nc, data = _hf_grid(dm)
    x = (ii.to(dm.dtype) / (nc - 1) * 2.0 - 1.0) * sz[0]
    y = (jj.to(dm.dtype) / (nr - 1) * 2.0 - 1.0) * sz[1]
    return torch.stack([x, y, data[jj * nc + ii] * sz[2] + top], -1)


def _hf_cell(f, n, offset=0.0):
    """The cell index (int64) of grid coordinate f, floor(f - offset),
    clamped to [0, n - 2]."""
    return torch.clamp(torch.floor(f - offset).long(), 0, n - 2)


def hfield_height(dm: DeviceModel, x, y):
    """Bilinear height of the heightfield's surface above its base at local
    (x, y) (any shape), the grid coordinates clamped to [0, n - 1.001]."""
    sz, nr, nc, data = _hf_grid(dm)
    fx = torch.clamp((x / sz[0] + 1.0) * 0.5 * (nc - 1), 0.0, nc - 1.001)
    fy = torch.clamp((y / sz[1] + 1.0) * 0.5 * (nr - 1), 0.0, nr - 1.001)
    i, j = _hf_cell(fx, nc), _hf_cell(fy, nr)
    tx, ty = fx - i, fy - j
    h = lambda jj, ii: data[jj * nc + ii]
    return (h(j, i) * (1 - tx) * (1 - ty) + h(j, i + 1) * tx * (1 - ty)
            + h(j + 1, i) * (1 - tx) * ty + h(j + 1, i + 1) * tx * ty) * sz[2]


def _closest_point_triangle(p, a, b, c):
    """(closest point of triangle (a, b, c) to p, the point lies in the face
    region), all (..., 3), Ericson's regions in order (vertex a, b, c, then
    edges ab, ac, bc, else the face; an earlier region wins). Degenerate
    edge denominators of exactly 0 are replaced by 1."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_in = torch.clamp_min(va + vb + vc, 1e-30)
    q = a + ab * (vb / denom_in)[..., None] + ac * (vc / denom_in)[..., None]
    nz = lambda x: torch.where(x == 0, 1.0, x)
    v_ab = torch.clamp(d1 / nz(d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(d2 / nz(d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / nz((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    for region, point in ((on_bc, b + t_bc[..., None] * (c - b)), (on_ac, a + w_ac[..., None] * ac),
                          (on_ab, a + v_ab[..., None] * ab), (in_c, c), (in_b, b), (in_a, a)):
        q = torch.where(region[..., None], point, q)
    return q, ~(in_a | in_b | in_c | on_ab | on_ac | on_bc)


def _sphere_triangle(center, radius, a, b, c):
    """(dist, pos, n) of a sphere against a triangle wound counter-clockwise
    from +z, n from the triangle toward the center. Where the closest point
    lies in the face region the distance is signed by the triangle's normal
    (a center below the face is inside its prism); on an edge or vertex it
    is unsigned (a center below the plane but off the footprint is not
    inside this prism)."""
    q, in_face = _closest_point_triangle(center, a, b, c)
    n_tri = _cross(b - a, c - a)
    n_tri = n_tri / torch.clamp_min(_norm(n_tri, keepdim=True), 1e-30)
    dvec = center - q
    dlen = _norm(dvec)
    side = torch.sign(_dot(dvec, n_tri))
    side = torch.where((side == 0) | ~in_face, 1.0, side)
    n = torch.where((dlen > 1e-12)[..., None],
                    side[..., None] * dvec / torch.clamp_min(dlen, 1e-12)[..., None], n_tri)
    dist = side * dlen - radius
    pos = center - n * (radius + 0.5 * dist)[..., None]
    return dist, pos, n


def _hfield_sphere(dm: DeviceModel, hpos, hmat, center, radius, margin):
    """Sphere against the heightfield: 8 slots, the sphere against both
    triangles of each cell of the 2 x 2 neighbourhood that the AABB of its
    radius inflated by margin/2 spans (a cell clamped onto another at the
    grid's border is dropped, dist 1e6). Tops raised by margin and radius
    r + margin/2: MuJoCo's convex heightfield pipeline collides the
    inflated sphere with raised prisms and reports that contact as it is.
    center (..., 3), radius and margin tensors broadcasting against its
    leading dims. Returns dist (..., 8), pos and n (..., 8, 3)."""
    sz, nr, nc, _ = _hf_grid(dm)
    local = ccd._dotR(center - hpos, hmat)
    fx = (local[..., 0] / sz[0] + 1.0) * 0.5 * (nc - 1)
    fy = (local[..., 1] / sz[1] + 1.0) * 0.5 * (nr - 1)
    r_eff = radius + 0.5 * margin
    rx = r_eff / sz[0] * 0.5 * (nc - 1)
    ry = r_eff / sz[1] * 0.5 * (nr - 1)
    i0, i1 = _hf_cell(fx, nc, rx), _hf_cell(fx, nc, -rx)
    j0, j1 = _hf_cell(fy, nr, ry), _hf_cell(fy, nr, -ry)
    ii = torch.stack([i0, i1, i0, i1], -1)                             # (..., 4) cells
    jj = torch.stack([j0, j0, j1, j1], -1)
    di, dj = i1 == i0, j1 == j0
    dup = torch.stack([torch.zeros_like(di), di, dj, di | dj], -1)
    top = margin[..., None]
    v00, v10 = _hf_corner(dm, jj, ii, top), _hf_corner(dm, jj, ii + 1, top)
    v01, v11 = _hf_corner(dm, jj + 1, ii, top), _hf_corner(dm, jj + 1, ii + 1, top)
    tri = lambda x, y: torch.stack([x, y], -2).flatten(-3, -2)        # (..., 8, 3)
    d, p, n = _sphere_triangle(local[..., None, :], r_eff[..., None],
                               tri(v00, v00), tri(v10, v11), tri(v11, v01))
    d = torch.where(dup.repeat_interleave(2, -1), 1e6, d)
    hm = hmat[..., None, :, :]
    return d, ccd._dotRT(p, hm) + hpos[..., None, :], ccd._dotRT(n, hm)


def _hfield_point_contact(dm: DeviceModel, local, r_eff, margin):
    """The deeper of a sphere of radius r_eff at local (..., 3) against the
    two raised triangles of the cell under it (the first on ties): (dist,
    pos, n), local frame."""
    sz, nr, nc, _ = _hf_grid(dm)
    i = _hf_cell((local[..., 0] / sz[0] + 1.0) * 0.5 * (nc - 1), nc)
    j = _hf_cell((local[..., 1] / sz[1] + 1.0) * 0.5 * (nr - 1), nr)
    v00, v10 = _hf_corner(dm, j, i, margin), _hf_corner(dm, j, i + 1, margin)
    v01, v11 = _hf_corner(dm, j + 1, i, margin), _hf_corner(dm, j + 1, i + 1, margin)
    d, p, n = _sphere_triangle(local[..., None, :], r_eff[..., None],
                               torch.stack([v00, v00], -2), torch.stack([v10, v11], -2),
                               torch.stack([v11, v01], -2))
    take1 = d[..., 0] <= d[..., 1]
    return (torch.where(take1, d[..., 0], d[..., 1]),
            torch.where(take1[..., None], p[..., 0, :], p[..., 1, :]),
            torch.where(take1[..., None], n[..., 0, :], n[..., 1, :]))


def _capsule_ends(cpos, cmat, halflen):
    """(B, G, 2, 3): the capsule's or cylinder's axis ends, + then -."""
    axis = cmat[..., :, 2]
    return torch.stack([cpos + axis * halflen[:, None], cpos + axis * (-1.0 * halflen)[:, None]], -2)


def _hfield_capsule(dm: DeviceModel, hpos, hmat, cpos, cmat, radius, halflen, margin):
    """Capsule against the heightfield: 16 + 5 slots. Its end spheres by
    `_hfield_sphere` (16), then 5 interior axis samples at t = -2/3 ... 2/3
    of the half-length, each a sphere against the raised triangles of the
    cell under it, for a body lying across a ridge; a sample within 2 mm of
    an end contact closer than margin + 1e-6 is dropped. All (B, G, ...)."""
    d, p, n = _hfield_sphere(dm, hpos[:, :, None], hmat[:, :, None],
                             _capsule_ends(cpos, cmat, halflen), radius[:, None], margin[:, None])
    B, G = d.shape[:2]
    d, p, n = d.reshape(B, G, 16), p.reshape(B, G, 16, 3), n.reshape(B, G, 16, 3)
    ts = dm.const('capsule_samples', lambda: np.array([-2.0 / 3, -1.0 / 3, 0.0, 1.0 / 3, 2.0 / 3]))
    centers = cpos[:, :, None] + (ts * halflen[:, None])[..., None] * cmat[:, :, None, :, 2]
    hm = hmat[:, :, None]
    di, pi, ni = _hfield_point_contact(dm, ccd._dotR(centers - hpos[:, :, None], hm),
                                       (radius + 0.5 * margin)[:, None], margin[:, None])
    pi = ccd._dotRT(pi, hm) + hpos[:, :, None]
    ni = ccd._dotRT(ni, hm)
    dd = _norm(pi[..., :, None, :] - p[..., None, :, :])               # (B, G, 5, 16)
    dup = ((dd < 2e-3) & (d[..., None, :] < (margin + 1e-6)[:, None, None])).any(-1)
    di = torch.where(dup, 1e6, di)
    return torch.cat([d, di], -1), torch.cat([p, pi], -2), torch.cat([n, ni], -2)


def _clip_into_prism(pt, verts, zbot):
    """Approximate projection of pt (..., 3) into a heightfield prism (verts
    (..., 6, 3), the top triangle first): onto the top plane from above,
    then the triangle's footprint in the plane, then z clamped between the
    base `zbot` and the top."""
    v0, v1, v2 = verts[..., 0, :], verts[..., 1, :], verts[..., 2, :]
    tn = _cross(v1 - v0, v2 - v1)
    tn = tn * torch.sign(tn[..., 2:3])
    tn = tn / torch.clamp_min(_norm(tn, keepdim=True), 1e-30)
    exc = torch.clamp_min(_dot(pt - v0, tn), 0.0)
    q = pt - exc[..., None] * tn
    flat = lambda v: torch.cat([v[..., :2], torch.zeros_like(v[..., 2:])], -1)
    qxy = ccd.clip_onto_triangle(flat(q), flat(v0), flat(v1), flat(v2))
    zt = v0[..., 2] - (tn[..., 0] * (qxy[..., 0] - v0[..., 0])
                       + tn[..., 1] * (qxy[..., 1] - v0[..., 1])) / torch.clamp_min(tn[..., 2], 1e-6)
    z = torch.minimum(torch.clamp_min(q[..., 2], zbot), zt)
    return torch.stack([qxy[..., 0], qxy[..., 1], z], -1)


def _hfield_convex_ccd(dm: DeviceModel, hpos, hmat, gpos, gmat, margin, shape: _Shape, dims,
                       rbound, n_span):
    """A convex geom (box or cylinder: `shape`, its sizes `dims`, each (G,)
    or (G, 3)) against the heightfield: _HF_CONVEX_K slots, one contact per
    prism, as MuJoCo's convex heightfield pipeline emits them (its multiccd
    does not apply here).

    The footprint is n_span x n_span cells from the cell under the geom's
    center less its bounding radius `rbound` (G,), clamped cells masked
    out: P = 2 n_span^2 prisms of raised tops, bases at the heightfield's
    bottom. Per prism, batched over (B, G, P): SAT over 20 candidate axes
    (z, the top normal, the side normals, the geom's axes and the crosses
    of the 3 top edges and z with each), 14 rounds of pattern refinement
    and the snap onto the feature axes. Then the K deepest prisms by
    repeated masked max, the lowest prism first on exact ties, masking only
    the one taken (a feature shared by several prisms gives one contact per
    prism); an empty pick has zero vertices and direction +z. Per taken
    prism, batched over (B, G, K): the witness starts from the tied prism
    vertex that moves least when clipped into the geom translated by the
    depth, the geom's support point and their midpoint. The depth is the
    one-hot product of the prism depths, as the reference takes it: NaN,
    and the slot dropped, where any prism of the footprint is masked. dist
    = -depth - margin/2 (dist 1e6 when not deeper than -margin). Returns
    dist (B, G, K), pos and n (B, G, K, 3)."""
    sz, nr, nc, _ = _hf_grid(dm)
    lp = ccd._dotR(gpos - hpos, hmat)                                  # (B, G, 3)
    lR = hmat.transpose(-1, -2) @ gmat                                 # (B, G, 3, 3)

    def geom(k):
        """The geom's local pose and sizes with k axes after (B, G)."""
        one = (1,) * k
        return (lp.reshape(lp.shape[:2] + one + (3,)), lR.reshape(lR.shape[:2] + one + (3, 3)),
                *(x.reshape(x.shape[:1] + one + x.shape[1:]) if torch.is_tensor(x) else x
                  for x in dims))

    fx = (lp[..., 0] / sz[0] + 1.0) * 0.5 * (nc - 1)
    fy = (lp[..., 1] / sz[1] + 1.0) * 0.5 * (nr - 1)
    i0 = torch.floor(fx - rbound / sz[0] * 0.5 * (nc - 1)).long()[..., None]
    j0 = torch.floor(fy - rbound / sz[1] * 0.5 * (nr - 1)).long()[..., None]
    offs = np.arange(n_span)
    i_off = i0 + dm.const(('hfield_di', n_span), lambda: np.tile(offs, n_span))
    j_off = j0 + dm.const(('hfield_dj', n_span), lambda: np.repeat(offs, n_span))
    ii, jj = torch.clamp(i_off, 0, nc - 2), torch.clamp(j_off, 0, nr - 2)   # (B, G, C)
    is_dup = ((i_off != ii) | (j_off != jj)).repeat_interleave(2, -1)      # (B, G, P)
    top = margin[:, None]
    v00, v10 = _hf_corner(dm, jj, ii, top), _hf_corner(dm, jj, ii + 1, top)
    v01, v11 = _hf_corner(dm, jj + 1, ii, top), _hf_corner(dm, jj + 1, ii + 1, top)
    tops = torch.stack([torch.stack([v00, v10, v11], -2), torch.stack([v00, v11, v01], -2)],
                       -3).flatten(-4, -3)                             # (B, G, P, 3, 3)
    bases = tops.clone()
    bases[..., 2] = -sz[3]
    verts = torch.cat([tops, bases], -2)                               # (B, G, P, 6, 3)
    vertex = verts[:, :, :, None].unbind(-2)       # 6 x (B, G, P, 1, 3)
    g2 = geom(2)

    def depth_fn(dirs):                     # (B, G, P, N, 3) -> (B, G, P, N)
        # the prism's support value, a running max over its vertices (a
        # batched matmul here splits into hundreds of small cuBLAS calls)
        sa = _dot(dirs, vertex[0])
        for v in vertex[1:]:
            sa = torch.maximum(sa, _dot(dirs, v))
        return sa + shape.supval(-dirs, *g2)

    e0 = tops[..., 1, :] - tops[..., 0, :]
    e1 = tops[..., 2, :] - tops[..., 1, :]
    e2 = tops[..., 0, :] - tops[..., 2, :]
    zax = torch.zeros_like(e0)
    zax[..., 2] = 1.0
    top_n = _cross(e0, e1)
    cands = [zax, top_n, _cross(e0, zax), _cross(e1, zax), _cross(e2, zax)]
    for i in range(3):
        g = lR[:, :, None, :, i].expand_as(e0)
        cands += [g] + [_cross(e, g) for e in (e0, e1, e2, zax)]
    d0_depth, d0 = ccd.best_axis(depth_fn, torch.stack(cands, -2))
    depths, dirs = ccd.pattern_refine(depth_fn, d0, d0_depth, rounds=14)
    top_u = top_n / torch.clamp_min(_norm(top_n, keepdim=True), 1e-12)
    axes0 = torch.cat([zax[..., None, :], top_u[..., None, :],
                       lR.transpose(-1, -2)[:, :, None].expand_as(tops)], -2)
    depths, dirs = ccd.snap_polish(depth_fn, depths, dirs, axes0)
    depths = torch.where(is_dup, -torch.inf, depths)                   # (B, G, P)

    remaining, ohs = depths, []
    for _ in range(_HF_CONVEX_K):
        sel = (remaining >= remaining.amax(-1, keepdim=True)) & torch.isfinite(remaining)
        sel = sel.to(depths.dtype)
        oh = (torch.cumsum(sel, -1) <= 1.0) * sel
        ohs.append(oh)
        remaining = torch.where(oh > 0.5, -torch.inf, remaining)
    oh = torch.stack(ohs, -2)                                          # (B, G, K, P)
    picked = oh.sum(-1) > 0.5
    idx = ccd._first_true(oh > 0.5)
    verts_k = torch.where(picked[..., None, None], torch.take_along_dim(
        verts, idx[..., None, None], dim=2), 0.0)                # (B, G, K, 6, 3)
    depth_k = (oh * depths[:, :, None]).sum(-1)
    dir_k = torch.where(picked[..., None], torch.take_along_dim(dirs, idx[..., None], dim=2), 0.0)
    dn = _norm(dir_k, keepdim=True)
    dir_k = torch.where(dn > 1e-6, dir_k / torch.clamp_min(dn, 1e-12), zax[:, :, :1])
    got = picked & (depth_k > -margin[:, None])

    g1, g2 = geom(1), geom(2)
    face_k = shape.face(-dir_k, *g1)
    # the support tie: with dir_k perpendicular to a prism edge, several
    # vertices are extreme, and only the one inside the geom translated by
    # the depth (the touch lens) is where the two touch
    vals = (verts_k * dir_k[..., None, :]).sum(-1)                     # (B, G, K, 6)
    tied = vals >= vals.amax(-1, keepdim=True) - 1e-9
    shift_k = (depth_k[..., None] * dir_k)[..., None, :]
    moved = _norm(shape.clip_into(verts_k - shift_k, *g2) + shift_k - verts_k)
    score = torch.where(tied, moved, torch.inf)
    vsel = (score <= score.amin(-1, keepdim=True)).to(depths.dtype)
    vsel = vsel * (torch.cumsum(vsel, -1) <= 1.0)
    xa = (vsel[..., None] * verts_k).sum(-2)
    xb = shape.support(-dir_k, *g1)
    # the three starts stacked on an axis after K: the clips broadcast over it
    vs = verts_k.unsqueeze(3)
    face_s = [f.unsqueeze(3) for f in face_k]
    pos_k = ccd.witness(
        dir_k, depth_k, torch.stack([xa, xb, 0.5 * (xa + xb)], 3),
        lambda pt: ccd.clip_onto_triangle(pt, vs[..., 0, :], vs[..., 1, :], vs[..., 2, :]),
        lambda pt: shape.clip_face(pt, *g2, *face_s, -dir_k.unsqueeze(3)),
        lambda pt: _clip_into_prism(pt, vs, -sz[3]),
        lambda pt: shape.clip_into(pt, *g2))
    d = torch.where(got, -depth_k - 0.5 * margin[:, None], 1e6)
    hm = hmat[:, :, None]
    return d, ccd._dotRT(pos_k, hm) + hpos[:, :, None], ccd._dotRT(dir_k, hm)


def hfield_span(m: Model, geom_ids) -> int:
    """Static per-axis footprint cell count of a group of heightfield-convex
    pairs: the group's largest circumscribed diameter over the cell, + 2,
    at most 8."""
    cell = 2.0 * float(np.min(np.asarray(m.hfield_size)[:2])) / \
        (min(m.hfield_nrow, m.hfield_ncol) - 1)
    rmax = float(np.max(np.linalg.norm(np.asarray(m.geom_size)[np.asarray(geom_ids)], axis=-1)))
    return min(int(np.ceil(2.0 * rmax / cell)) + 2, 8)


def _merge_local_samples(margin, dc, pc, nc_, d4, p4, n4):
    """The CCD's slots (B, G, K) and the 4 local samples' (B, G, 4), world
    frame: a CCD contact within 2 mm of a sample closer than margin + 1e-6
    is dropped (the sample, measured locally as MuJoCo's pipeline measures,
    wins)."""
    dd = _norm(p4[..., :, None, :] - pc[..., None, :, :])              # (B, G, 4, K)
    dup = ((dd < 2e-3) & (d4[..., None] < (margin + 1e-6)[:, None, None])).any(-2)
    return (torch.cat([torch.where(dup, 1e6, dc), d4], -1), torch.cat([pc, p4], -2),
            torch.cat([nc_, n4], -2))


def _hfield_box(dm: DeviceModel, hpos, hmat, bpos, bmat, size, margin, n_span, signs):
    """Box against the heightfield: the per-prism CCD (8 slots), then the
    4 deepest of the box's 8 corners, each a point (radius margin/2)
    against the raised triangles of its cell, merged
    (`_merge_local_samples`): 12 slots."""
    dc, pc, nc_ = _hfield_convex_ccd(dm, hpos, hmat, bpos, bmat, margin, _BOX, (size,),
                                     _norm(size), n_span)
    hm = hmat[:, :, None]
    local = ccd._dotR(_box_corners(bpos, bmat, size, signs) - hpos[:, :, None], hm)
    d, p, n = _hfield_point_contact(dm, local, (0.5 * margin)[:, None], margin[:, None])
    d4, p4, n4 = _deepest_k(d, p, n, 4)
    return _merge_local_samples(margin, dc, pc, nc_, d4, ccd._dotRT(p4, hm) + hpos[:, :, None],
                                ccd._dotRT(n4, hm))


def _hfield_cylinder(dm: DeviceModel, hpos, hmat, cpos, cmat, radius, halflen, margin, n_span):
    """Cylinder against the heightfield: the per-prism CCD (8 slots), then
    the 4 deepest of its end spheres' 16 `_hfield_sphere` slots, merged
    (`_merge_local_samples`): 12 slots."""
    dc, pc, nc_ = _hfield_convex_ccd(dm, hpos, hmat, cpos, cmat, margin, _CYLINDER,
                                     (radius, halflen),
                                     torch.sqrt(radius * radius + halflen * halflen), n_span)
    d, p, n = _hfield_sphere(dm, hpos[:, :, None], hmat[:, :, None],
                             _capsule_ends(cpos, cmat, halflen), radius[:, None], margin[:, None])
    B, G = d.shape[:2]
    d4, p4, n4 = _deepest_k(d.reshape(B, G, 16), p.reshape(B, G, 16, 3), n.reshape(B, G, 16, 3), 4)
    return _merge_local_samples(margin, dc, pc, nc_, d4, p4, n4)


def hfield_span_rbound(m: Model, geom_ids) -> int:
    """`hfield_span` of a group of heightfield-mesh pairs: a mesh's
    footprint radius is its geom_rbound (the hull's circumscribed radius)."""
    cell = 2.0 * float(np.min(np.asarray(m.hfield_size)[:2])) / \
        (min(m.hfield_nrow, m.hfield_ncol) - 1)
    rmax = float(np.max(np.asarray(m.geom_rbound)[np.asarray(geom_ids)]))
    return min(int(np.ceil(2.0 * rmax / cell)) + 2, 8)


def _hfield_mesh(dm: DeviceModel, hpos, hmat, gpos, gmat, hs: HullSet, nvert, rbound, margin,
                 n_span):
    """Convex mesh hull against the heightfield: the per-prism CCD with the
    hull as its geom (8 slots; support and witness on the hull's vertices,
    pads collapsed to vertex 0, since the origin need not lie inside an
    off-center hull), then the 4 deepest hull vertices, each a point
    (radius margin/2) against the raised triangles of its cell, merged
    (`_merge_local_samples`): 12 slots. hs the hulls' `HullSet` (its padded
    table with the pads collapsed), nvert and rbound (G,)."""
    V = hs.padded
    pad = torch.arange(V.shape[-2], device=V.device) >= nvert[:, None]
    dc, pc, nc_ = _hfield_convex_ccd(dm, hpos, hmat, gpos, gmat, margin, _HULL, (hs,), rbound,
                                     n_span)
    lp = ccd._dotR(gpos - hpos, hmat)
    lR = hmat.transpose(-1, -2) @ gmat
    d, p, n = _hfield_point_contact(dm, _hull_local(lp, lR, V), (0.5 * margin)[:, None],
                                    margin[:, None])
    d4, p4, n4 = _deepest_k(torch.where(pad, 1e6, d), p, n, 4)
    hm = hmat[:, :, None]
    return _merge_local_samples(margin, dc, pc, nc_, d4, ccd._dotRT(p4, hm) + hpos[:, :, None],
                                ccd._dotRT(n4, hm))


# ---------------------------------------------------------------------------------
# contact frame (MuJoCo mju_makeFrame tangents)
# ---------------------------------------------------------------------------------

def make_frame(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) normal -> (..., 3, 3) frame rows (n, t1, t2), mju_makeFrame:
    the helper is the world axis least aligned with n, chosen with strict `<`
    so that ties pick the later axis (the floor normal (0, 0, 1) takes y),
    Gram-Schmidt against n gives t1, and t2 = n x t1."""
    a = n.abs()
    ax, ay, az = a.unbind(-1)
    pick_x = (ax < ay) & (ax < az)
    pick_y = ~pick_x & (ay < az)
    pick_z = ~pick_x & ~pick_y
    helper = torch.stack([pick_x, pick_y, pick_z], -1).to(n.dtype)
    t1 = helper - n * (n * helper).sum(-1, keepdim=True)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-12)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([n, t1, t2], -2)


# ---------------------------------------------------------------------------------
# full narrow phase
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class Contacts:
    """Fixed-slot contact set. `feat` is (B, 7, S): row 0 = dist, rows 1:4 =
    pos, rows 4:7 = normal, slots in the static layout order."""

    feat: torch.Tensor

    @property
    def dist(self):
        return self.feat[:, 0]

    @property
    def pos(self):
        return self.feat[:, 1:4].transpose(1, 2)

    @property
    def normal(self):
        return self.feat[:, 4:7].transpose(1, 2)


class Hulls(NamedTuple):
    """A mesh group's static hull tables (None where a side is no mesh):
    the `HullSet` of geom 1 (a box's 8 corners in a box-mesh group) and of
    geom 2 (in a heightfield-mesh group with the pads collapsed onto vertex
    0), geom 2's vertex counts and circumscribed radii (G,) and hull graph
    (G, Vmax, D), and the footprint span of a heightfield-mesh group."""

    hulls1: HullSet | None
    hulls2: HullSet
    nvert2: torch.Tensor
    rbound2: torch.Tensor
    nbr2: torch.Tensor
    span: int | None


def _group(dm: DeviceModel, key, p1, R1, s1, p2, R2, s2, margin, aux):
    """One pair group's (dist (B, G, k), pos, normal (B, G, k, 3)). margin
    (G,) is the pairs' margin; aux the static footprint of a
    heightfield-convex group (`hfield_span`), a mesh group's `Hulls`, else
    None."""
    signs = dm.const('box_corner_signs', lambda: _BOX_CORNER_SIGNS)
    up = dm.const('up', lambda: np.array([0.0, 0.0, 1.0]))   # normal of coincident centers
    if key == (GEOM_PLANE, GEOM_SPHERE):
        return _plane_sphere(p1, R1, p2, s2[:, 0])
    if key == (GEOM_PLANE, GEOM_CAPSULE):
        return _plane_capsule(p1, R1, p2, R2, s2[:, 0], s2[:, 1])
    if key == (GEOM_PLANE, GEOM_BOX):
        return _plane_box(p1, R1, p2, R2, s2, signs)
    if key == (GEOM_PLANE, GEOM_CYLINDER):
        return _plane_cylinder(p1, R1, p2, R2, s2[:, 0], s2[:, 1])
    if key == (GEOM_BOX, GEOM_SPHERE):           # world box
        return _box_sphere(p1, R1, s1, p2, s2[:, 0])
    if key == (GEOM_BOX, GEOM_CAPSULE):          # world box: the CCD runs capsule first
        d, p, n = _ccd_box(_CAPSULE, p2, R2, s2[:, 0], s2[:, 1], p1, R1, s1, signs)
        return d, p, -n
    # the heightfield: the margin bias of MuJoCo's convex heightfield pipeline
    if key == (GEOM_HFIELD, GEOM_SPHERE):
        return _hfield_sphere(dm, p1, R1, p2, s2[:, 0], margin)
    if key == (GEOM_HFIELD, GEOM_CAPSULE):
        return _hfield_capsule(dm, p1, R1, p2, R2, s2[:, 0], s2[:, 1], margin)
    if key == (GEOM_HFIELD, GEOM_BOX):
        return _hfield_box(dm, p1, R1, p2, R2, s2, margin, aux, signs)
    if key == (GEOM_HFIELD, GEOM_CYLINDER):
        return _hfield_cylinder(dm, p1, R1, p2, R2, s2[:, 0], s2[:, 1], margin, aux)
    # mesh pairs
    if key == (GEOM_PLANE, GEOM_MESH):
        return _plane_mesh(p1, R1, p2, R2, aux.hulls2.padded, aux.nbr2, aux.nvert2, aux.rbound2,
                           margin)
    if key == (GEOM_HFIELD, GEOM_MESH):
        return _hfield_mesh(dm, p1, R1, p2, R2, aux.hulls2, aux.nvert2, aux.rbound2, margin,
                            aux.span)
    if key == (GEOM_SPHERE, GEOM_MESH):
        return _sphere_mesh(p1, s1[:, 0], p2, R2, aux.hulls2)
    if key in ((GEOM_BOX, GEOM_MESH), (GEOM_MESH, GEOM_MESH)):
        return _mesh_mesh(p1, R1, aux.hulls1, p2, R2, aux.hulls2, margin)
    # robot-robot pairs, type1 <= type2, normal geom1 -> geom2
    if key == (GEOM_SPHERE, GEOM_SPHERE):
        return _sphere_sphere(p1, s1[:, 0], p2, s2[:, 0], up)
    if key == (GEOM_SPHERE, GEOM_CAPSULE):
        return _sphere_capsule(p1, s1[:, 0], p2, R2, s2[:, 0], s2[:, 1], up)
    if key == (GEOM_SPHERE, GEOM_CYLINDER):
        return _sphere_cylinder(p1, s1[:, 0], p2, R2, s2[:, 0], s2[:, 1])
    if key == (GEOM_SPHERE, GEOM_BOX):           # _box_sphere's normal is box -> sphere
        d, p, n = _box_sphere(p2, R2, s2, p1, s1[:, 0])
        return d, p, -n
    if key in ((GEOM_CAPSULE, GEOM_CAPSULE), (GEOM_CAPSULE, GEOM_CYLINDER),
               (GEOM_CYLINDER, GEOM_CYLINDER)):
        # a cylinder as the capsule of its radius and half-length: the
        # reference's documented approximation of its flat caps and rims
        return _capsule_capsule(p1, R1, s1[:, 0], s1[:, 1], p2, R2, s2[:, 0], s2[:, 1], up)
    if key == (GEOM_CAPSULE, GEOM_BOX):
        return _ccd_box(_CAPSULE, p1, R1, s1[:, 0], s1[:, 1], p2, R2, s2, signs)
    if key == (GEOM_CYLINDER, GEOM_BOX):
        return _ccd_box(_CYLINDER, p1, R1, s1[:, 0], s1[:, 1], p2, R2, s2, signs)
    if key == (GEOM_BOX, GEOM_BOX):
        return _box_box(p1, R1, s1, p2, R2, s2, signs)
    raise AssertionError(key)   # contact_layout keeps only the pair types above


@functools.lru_cache(maxsize=64)
def _hfield_spans(m: Model) -> dict:
    """{(t1, t2): `hfield_span`} of the model's heightfield-convex groups."""
    spans = {(t1, t2): hfield_span(m, g2) for t1, t2, _, g2 in _pair_groups(m)
             if t1 == GEOM_HFIELD and t2 in (GEOM_BOX, GEOM_CYLINDER)}
    spans.update({(t1, t2): hfield_span_rbound(m, g2) for t1, t2, _, g2 in _pair_groups(m)
                  if (t1, t2) == (GEOM_HFIELD, GEOM_MESH)})
    return spans


def hull_set(dm: DeviceModel, name, ids, padded, counts) -> HullSet:
    """The `HullSet` of G pairs whose hulls have the ids `ids` (G,) (equal
    ids, equal hulls), padded (G, Vmax, 3) and live vertex counts (G,)
    (numpy). The pad rows of a hull are each the geom origin (an interior
    point, left out of its vertices) or, collapsed, its vertex 0 (counted
    in vertex 0's multiplicity)."""
    hulls = []
    uniq = np.unique(ids)
    for h in uniq:
        at = np.flatnonzero(ids == h)
        g, n = int(at[0]), int(counts[at[0]])
        verts = padded[g, :n]
        mult = np.ones(n)
        if np.array_equal(padded[g, n:], np.broadcast_to(verts[:1], padded[g, n:].shape)):
            mult[0] += padded.shape[1] - n
        idx = None if len(uniq) == 1 else dm.const((name, 'pairs', int(h)), lambda: at)
        hulls.append((idx, dm.const((name, 'verts', int(h)), lambda: verts),
                      dm.const((name, 'mult', int(h)), lambda: mult)))
    return HullSet(dm.const((name, 'padded'), lambda: padded), tuple(hulls))


def _hulls(dm: DeviceModel, key, g1, g2) -> Hulls:
    """The static hull tables of a mesh group on the model's device."""
    m = dm.m
    did2 = np.asarray(m.geom_dataid)[g2]
    nvert2 = m.mesh_vertnum[did2]
    verts2 = m.mesh_vert[did2]
    if key[0] == GEOM_MESH:
        did1 = np.asarray(m.geom_dataid)[g1]
        hulls1 = hull_set(dm, ('hull1', key), did1, m.mesh_vert[did1], m.mesh_vertnum[did1])
    elif key[0] == GEOM_BOX:
        corners = _BOX_CORNER_SIGNS[None] * np.asarray(m.geom_size)[g1][:, None, :]
        hulls1 = hull_set(dm, ('hull1', key), np.arange(len(g1)), corners, np.full(len(g1), 8))
    else:
        hulls1 = None
    if key[0] == GEOM_HFIELD:         # pads collapse onto vertex 0
        pad = np.arange(verts2.shape[1])[None] >= nvert2[:, None]
        verts2 = np.where(pad[..., None], verts2[:, :1], verts2)
    c = lambda name, make: dm.const(('hull', name, key), make)
    return Hulls(hulls1=hulls1,
                 hulls2=hull_set(dm, ('hull2', key), did2, verts2, nvert2),
                 nvert2=c('nvert2', lambda: m.mesh_vertnum[did2].astype(np.int64)),
                 rbound2=c('rbound2', lambda: np.asarray(m.geom_rbound)[g2]),
                 nbr2=c('nbr2', lambda: m.mesh_nbr[did2].astype(np.int64)),
                 span=_hfield_spans(m).get(key))


def group_args(dm: DeviceModel, kin):
    """For each pair-type group in slot order, the arguments of its `_group`
    call on FK results (B envs): the poses and sizes of its geoms 1 and 2,
    the pairs' margins (the sizes and margins are static, gathered once) and
    the group's heightfield footprint span, or a mesh group's `Hulls` (None
    for other groups)."""
    m = dm.m
    specs, first = contact_layout(m), 0
    for t1, t2, g1, g2 in _pair_groups(m):
        key = (t1, t2)
        margins = np.array([s.margin for s in specs[first:first + len(g1)]])
        first += len(g1)
        i1 = dm.const(('pair_g1', key), lambda: g1)
        i2 = dm.const(('pair_g2', key), lambda: g2)
        s1 = dm.const(('pair_size1', key), lambda: m.geom_size[g1])
        s2 = dm.const(('pair_size2', key), lambda: m.geom_size[g2])
        margin = dm.const(('pair_margin', key), lambda: margins)
        aux = (_hulls(dm, key, g1, g2) if GEOM_MESH in key
               else _hfield_spans(m).get(key))
        yield (dm, key, kin.geom_xpos[:, i1], kin.geom_xmat[:, i1], s1,
               kin.geom_xpos[:, i2], kin.geom_xmat[:, i2], s2, margin, aux)


def collide(dm: DeviceModel, kin) -> Contacts:
    """All contact slots from FK results (B envs), one batched primitive per
    pair-type group; a pair's slots are consecutive."""
    B = kin.geom_xpos.shape[0]
    feats = []
    for args in group_args(dm, kin):
        d, p, n = _group(*args)
        S = d.shape[1] * d.shape[2]
        feats.append(torch.cat([d.reshape(B, 1, S), p.reshape(B, S, 3).transpose(1, 2),
                                n.reshape(B, S, 3).transpose(1, 2)], 1))   # (B, 7, S)
    if not feats:
        return Contacts(kin.geom_xpos.new_zeros(B, 7, 0))
    return Contacts(torch.cat(feats, 2))
