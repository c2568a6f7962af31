"""Narrow phase, batched over envs: robot primitives against world geoms in
fixed contact slots.

Counterpart of gym_quadruped_tpu/physics/collision.py (MuJoCo's
mj_collision). The candidate pairs are static (Model.contact_pairs); every
pair owns a fixed number of slots, always computed and masked later by
`dist < margin`. The contact normal points from geom1 (world) to geom2
(robot); `dist` is the signed separation (negative = penetration) and `pos`
the midpoint.

Ported pair groups: plane-sphere and sphere-sphere (every pair of spot/flat).
`collide` raises NotImplementedError for any other group. The slot layout
(`contact_layout`) covers every pair type of the reference, so the static
tables agree for every model.
"""

from __future__ import annotations

import dataclasses
import functools

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
# primitive tests: (B, G, ...) poses in, (B, G) dist, (B, G, 3) pos and normal out
# ---------------------------------------------------------------------------------

def _plane_sphere(ppos, pmat, center, radius):
    n = pmat[..., :, 2]
    d = (n * (center - ppos)).sum(-1) - radius
    pos = center - n * (radius + 0.5 * d)[..., None]
    return d, pos, n


def _sphere_sphere(p1, r1, p2, r2, up):
    d12 = p2 - p1
    dlen = torch.linalg.vector_norm(d12, dim=-1)
    n = torch.where((dlen > 1e-12)[..., None],
                    d12 / torch.clamp_min(dlen, 1e-12)[..., None], up)
    dist = dlen - r1 - r2
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


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


def collide(dm: DeviceModel, kin) -> Contacts:
    """All contact slots from FK results (B envs), one batched primitive per
    pair-type group."""
    m = dm.m
    B = kin.geom_xpos.shape[0]
    feats = []
    for t1, t2, g1, g2 in _pair_groups(m):
        key = (t1, t2)
        i1 = dm.const(('pair_g1', key), lambda: g1)
        i2 = dm.const(('pair_g2', key), lambda: g2)
        p1, R1 = kin.geom_xpos[:, i1], kin.geom_xmat[:, i1]
        p2 = kin.geom_xpos[:, i2]
        if key == (GEOM_PLANE, GEOM_SPHERE):
            d, p, n = _plane_sphere(p1, R1, p2, dm.geom_size[i2, 0])
        elif key == (GEOM_SPHERE, GEOM_SPHERE):
            up = dm.const('up', lambda: np.array([0.0, 0.0, 1.0]))
            d, p, n = _sphere_sphere(p1, dm.geom_size[i1, 0], p2,
                                     dm.geom_size[i2, 0], up)
        else:
            raise NotImplementedError(
                f'narrow phase for {_GEOM_NAMES.get(t1, t1)}-'
                f'{_GEOM_NAMES.get(t2, t2)} pairs is not ported '
                f'(ported: plane-sphere, sphere-sphere)')
        feats.append(torch.cat([d[:, None], p.transpose(1, 2),
                                n.transpose(1, 2)], 1))      # (B, 7, G)
    if not feats:
        return Contacts(kin.geom_xpos.new_zeros(B, 7, 0))
    return Contacts(torch.cat(feats, 2))
