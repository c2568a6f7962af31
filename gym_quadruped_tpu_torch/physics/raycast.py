"""Analytic ray casting, batched over envs and rays.

Counterpart of gym_quadruped_tpu/physics/raycast.py (MuJoCo's mj_ray): rays
of shape (B, N, 3) against the static world geoms (plane, box, heightfield)
and, when a `Kin` poses them, the robot's primitives (box, sphere, capsule,
cylinder as a capsule), then the nearest hit. Used by the heightmap (the
static world, straight down) and the depth camera (world and robot).

The geoms of one primitive type are cast together over (B, G, N). The
nearest hit is reduced as the reference's argmin over its stacked rows (a
miss sentinel, the world geoms by index, then the robot's by index): the
first of equal distances wins. The envs are cast in chunks of a bounded
number of ray-geom pairs (RAY_CHUNK), each the same arithmetic, so that a
camera over thousands of envs fits in memory.
"""

from __future__ import annotations

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_HFIELD,
    GEOM_PLANE,
    GEOM_SPHERE,
    DeviceModel,
    Model,
)
from gym_quadruped_tpu_torch.physics.collision import hfield_height
from gym_quadruped_tpu_torch.utils.maths import quat_to_mat

_BIG = 1e9
# The heightfield's oblique rays are marched in MARCH_SAMPLES samples over the
# ray's overlap with its box, then bisected BISECTIONS times. The samples'
# fractions are the reference's jnp.linspace(0, 1, 64) bit for bit: i times
# the rounded 1/63 (XLA divides by a constant through its reciprocal), the
# last exactly 1. i / 63 differs in 8 of them, torch.linspace in 16 (f64).
MARCH_SAMPLES = 64
MARCH_FRACTIONS = np.append(np.arange(MARCH_SAMPLES - 1) * (1.0 / (MARCH_SAMPLES - 1)), 1.0)
BISECTIONS = 12
# Ray-geom pairs (or ray-samples of the march) cast at once: the envs are cast
# in chunks of at most this many, a few GB of temporaries in f32.
RAY_CHUNK = 1 << 24


def _dot(a, b):
    return (a * b).sum(-1)


def _local(gmat, v):
    """gmat^T v over the last axis: v in the geom's frame."""
    return (v[..., :, None] * gmat).sum(-2)


# ---------------------------------------------------------------------------
# per-primitive tests: (geom pose and size, o, d) -> t >= 0 or _BIG, every
# argument broadcasting over the leading axes
# ---------------------------------------------------------------------------

def ray_plane(gpos, gmat, size, o, d):
    n = gmat[..., :, 2]
    denom = _dot(d, n)
    safe = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = -_dot(o - gpos, n) / safe
    return torch.where((t >= 0) & (denom.abs() > 1e-12), t, _BIG)


def ray_box(gpos, gmat, size, o, d):
    ol = _local(gmat, o - gpos)
    dl = _local(gmat, d)
    dl = torch.where(dl.abs() < 1e-12, 1e-12, dl)
    t1 = (-size - ol) / dl
    t2 = (size - ol) / dl
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = tmax >= torch.clamp_min(tmin, 0.0)
    t = torch.where(tmin >= 0, tmin, tmax)
    return torch.where(hit & (t >= 0), t, _BIG)


def ray_sphere(gpos, gmat, size, o, d):
    r = size[..., 0]
    oc = o - gpos
    b = _dot(oc, d)
    c = _dot(oc, oc) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = torch.where(-b - sq >= 0, -b - sq, -b + sq)
    return torch.where((disc >= 0) & (t >= 0), t, _BIG)


def ray_capsule(gpos, gmat, size, o, d):
    """Capsule along local z: the infinite cylinder's solve clamped to the
    segment, and the two end spheres."""
    r, h = size[..., 0], size[..., 1]
    axis = gmat[..., :, 2]
    oc = o - gpos
    d_perp = d - _dot(d, axis)[..., None] * axis
    o_perp = oc - _dot(oc, axis)[..., None] * axis
    a = _dot(d_perp, d_perp)
    b = _dot(o_perp, d_perp)
    c = _dot(o_perp, o_perp) - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a < 1e-12, 1e-12, a)
    t_cyl = (-b - sq) / a_safe
    z_hit = _dot(oc + t_cyl[..., None] * d, axis)
    cyl_ok = (disc >= 0) & (a >= 1e-12) & (t_cyl >= 0) & (z_hit.abs() <= h)
    t_cyl = torch.where(cyl_ok, t_cyl, _BIG)
    t_cap1 = ray_sphere(gpos + axis * h[..., None], gmat, size, o, d)
    t_cap2 = ray_sphere(gpos - axis * h[..., None], gmat, size, o, d)
    return torch.minimum(t_cyl, torch.minimum(t_cap1, t_cap2))


def ray_hfield(dm: DeviceModel, gpos, gmat, o, d, march: bool = True):
    """The heightfield (its pose gpos (3,), gmat (3, 3)) against rays o, d
    (..., 3). Vertical rays solve the bilinear surface exactly; oblique rays
    march MARCH_SAMPLES samples over the ray's overlap with the field's box
    to the first one below the surface, then bisect BISECTIONS times. With
    `march` False every ray must be vertical (the march is skipped: its
    answer is not taken for a vertical ray)."""
    sz = dm.hfield_size
    lo = _local(gmat, o - gpos)
    ld = _local(gmat, d)
    vertical = (ld[..., 0].abs() < 1e-9) & (ld[..., 1].abs() < 1e-9)

    h0 = hfield_height(dm, lo[..., 0], lo[..., 1])
    inside0 = (lo[..., 0].abs() <= sz[0]) & (lo[..., 1].abs() <= sz[1])
    dz = torch.where(ld[..., 2].abs() < 1e-12, -1e-12, ld[..., 2])
    t_vert = (h0 - lo[..., 2]) / dz
    t_vert = torch.where(inside0 & (t_vert >= 0), t_vert, _BIG)
    if not march:
        return t_vert

    lo_box = torch.stack([-sz[0], -sz[1], -sz[3]])
    hi_box = torch.stack([sz[0], sz[1], sz[2]])
    dl_safe = torch.where(ld.abs() < 1e-12, 1e-12, ld)
    tb1 = (lo_box - lo) / dl_safe
    tb2 = (hi_box - lo) / dl_safe
    t_enter = torch.clamp_min(torch.minimum(tb1, tb2).amax(-1), 0.0)
    t_exit = torch.maximum(tb1, tb2).amin(-1)
    span = torch.where(t_exit > t_enter, t_exit - t_enter, 0.0)
    fractions = dm.const('march_fractions', lambda: MARCH_FRACTIONS)
    ts = t_enter[..., None] + fractions * span[..., None]             # (..., S)
    pts = lo[..., None, :] + ts[..., None] * ld[..., None, :]         # (..., S, 3)
    hs = hfield_height(dm, pts[..., 0], pts[..., 1])
    inside = (pts[..., 0].abs() <= sz[0]) & (pts[..., 1].abs() <= sz[1])
    below = inside & (pts[..., 2] <= hs)
    idx = below.to(torch.int32).argmax(-1, keepdim=True)             # the first sample below
    t_lo = ts.gather(-1, torch.clamp_min(idx - 1, 0))[..., 0]
    t_hi = ts.gather(-1, idx)[..., 0]
    for _ in range(BISECTIONS):
        mid = 0.5 * (t_lo + t_hi)
        p = lo + mid[..., None] * ld
        under = p[..., 2] <= hfield_height(dm, p[..., 0], p[..., 1])
        t_lo, t_hi = torch.where(under, t_lo, mid), torch.where(under, mid, t_hi)
    t_march = torch.where(below.any(-1), 0.5 * (t_lo + t_hi), _BIG)
    return torch.where(vertical, t_vert, t_march)


_PRIM = {
    GEOM_PLANE: ray_plane,
    GEOM_BOX: ray_box,
    GEOM_SPHERE: ray_sphere,
    GEOM_CAPSULE: ray_capsule,
    GEOM_CYLINDER: ray_capsule,  # the reference's approximation, as in collision.py
}


# ---------------------------------------------------------------------------
# scene casting
# ---------------------------------------------------------------------------

def world_geoms(m: Model) -> tuple:
    """The static world geoms a ray meets: planes, heightfields and boxes of
    the world body, by index."""
    return tuple(g for g in range(m.ngeom) if int(m.geom_bodyid[g]) == 0
                 and int(m.geom_type[g]) in (GEOM_PLANE, GEOM_HFIELD, GEOM_BOX))


def robot_geoms(m: Model) -> tuple:
    """The robot's primitive geoms, by index."""
    return tuple(g for g in range(m.ngeom) if int(m.geom_bodyid[g]) != 0
                 and int(m.geom_type[g]) in _PRIM)


def static_mat(quat: np.ndarray) -> np.ndarray:
    """Rotation matrices of a model's static quaternions (..., 4), in f64,
    for `DeviceModel.const`."""
    return quat_to_mat(torch.as_tensor(quat, dtype=torch.float64)).numpy()


def _groups(m: Model, with_robot: bool) -> list:
    """[(world?, geom type, geom ids, their ranks in the reference's order)]:
    the candidate geoms grouped by primitive (capsules and cylinders
    together), in the reference's order: the world geoms by index, then the
    robot's."""
    order = world_geoms(m) + (robot_geoms(m) if with_robot else ())
    n_world = len(world_geoms(m))
    groups = {}
    for rank, g in enumerate(order):
        typ = int(m.geom_type[g])
        typ = GEOM_CAPSULE if typ == GEOM_CYLINDER else typ
        groups.setdefault((rank < n_world, typ), []).append((g, rank))
    return [(world, typ, tuple(g for g, _ in gs), tuple(r for _, r in gs))
            for (world, typ), gs in groups.items()]


def _cast_chunk(dm: DeviceModel, groups, o, d, kin, straight_down):
    """(t, geom id) of rays o, d (b, N, 3) of one chunk of envs, whose robot
    geoms (if any group needs them) are posed by `kin`'s rows of the chunk
    (geom_xpos, geom_xmat)."""
    m = dm.m
    best_t = torch.full(o.shape[:-1], _BIG, dtype=o.dtype, device=o.device)
    best_rank = torch.full(o.shape[:-1], -1, dtype=torch.int64, device=o.device)
    best_id = torch.full(o.shape[:-1], -1, dtype=torch.int64, device=o.device)
    for world, typ, ids, ranks in groups:
        key = ('ray', world, typ, ids)
        if world:
            gpos = dm.const(key + ('pos',), lambda: m.geom_pos[list(ids)])
            gmat = dm.const(key + ('mat',), lambda: static_mat(m.geom_quat[list(ids)]))
        else:
            idx = dm.const(key + ('idx',), lambda: np.array(ids))
            gpos, gmat = kin[0][:, idx], kin[1][:, idx]        # (b, G, 3), (b, G, 3, 3)
        if typ == GEOM_HFIELD:
            # one heightfield per model (Model.hfield_*): the march is skipped
            # for straight-down rays that it keeps vertical in its frame
            R = static_mat(m.geom_quat[ids[0]])
            march = not (straight_down and R[2, 0] == 0.0 and R[2, 1] == 0.0)
            t = torch.stack([ray_hfield(dm, gpos[i], gmat[i], o, d, march)
                             for i in range(len(ids))], 1)
        else:
            size = dm.const(key + ('size',), lambda: m.geom_size[list(ids)])[:, None]
            gpos, gmat = gpos[..., None, :], gmat[..., None, :, :]  # geom axis before N
            t = _PRIM[typ](gpos, gmat, size, o[..., None, :, :], d[..., None, :, :])
        t = t.expand(o.shape[0], len(ids), o.shape[1])           # (b, G, N)
        first = t.argmin(1, keepdim=True)                        # the first of equal t
        t_g = t.gather(1, first)[:, 0]
        rank_g = dm.const(key + ('rank',), lambda: np.array(ranks))[first[:, 0]]
        take = (t_g < best_t) | ((t_g == best_t) & (rank_g < best_rank))
        best_t = torch.where(take, t_g, best_t)
        best_rank = torch.where(take, rank_g, best_rank)
        best_id = torch.where(take, dm.const(key + ('ids',), lambda: np.array(ids))[first[:, 0]],
                              best_id)
    miss = best_t >= _BIG
    return torch.where(miss, -1.0, best_t), torch.where(miss, -1, best_id).to(torch.int32)


def _cast(dm: DeviceModel, origins, dirs, kin, straight_down=False):
    m = dm.m
    groups = _groups(m, kin is not None)
    B, N = origins.shape[:2]
    n_prims = sum(len(ids) for _, typ, ids, _ in groups if typ != GEOM_HFIELD)
    march = any(typ == GEOM_HFIELD for _, typ, _, _ in groups) and not straight_down
    per_env = N * max(n_prims, MARCH_SAMPLES if march else 1)
    chunk = max(1, min(B, RAY_CHUNK // max(per_env, 1)))
    poses = None if kin is None else (kin.geom_xpos, kin.geom_xmat)
    outs = []
    for s in range(0, B, chunk):
        part = None if poses is None else tuple(x[s:s + chunk] for x in poses)
        outs.append(_cast_chunk(dm, groups, origins[s:s + chunk], dirs[s:s + chunk], part,
                                straight_down))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([t for t, _ in outs]), torch.cat([g for _, g in outs])


def raycast(dm: DeviceModel, origins: torch.Tensor, dirs: torch.Tensor, kin=None):
    """Cast rays (B, N, 3) with unit directions: (t (B, N), geom id (B, N)
    int32), t = -1 and id = -1 on a miss. The static world geoms always take
    part; the robot's when `kin` (its FK, batched like the rays) poses them."""
    return _cast(dm, origins, dirs, kin)


def raycast_down(dm: DeviceModel, origins: torch.Tensor) -> torch.Tensor:
    """(B, N) distances of straight-down rays from origins (B, N, 3) to the
    static world; -1 on a miss."""
    down = dm.const('ray_down', lambda: np.array([0.0, 0.0, -1.0]))
    return _cast(dm, origins, down.expand_as(origins), None, straight_down=True)[0]
