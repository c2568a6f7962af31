"""Constraint assembly, batched over envs: MuJoCo's soft-constraint model with
a static row layout.

Counterpart of gym_quadruped_tpu/physics/constraints.py (mj_makeConstraint /
mj_projectConstraint). Two groups:

  * simple rows: dof friction loss (Huber), joint limits (one-sided) and
    the contact slots that are no cone block: with cone = pyramidal and one
    condim > 1, 2 (condim - 1) one-sided rows per slot, culled to the
    `max_cone` nearest slots before assembly; else every such slot, unculled
    (`simple_slot_rows`): a dense (B, ns, nv) Jacobian;
  * cone blocks: elliptic contacts with condim > 1, a padded (B, C, 6, nv)
    Jacobian per slot, culled to the `max_cone` nearest slots before assembly.

Soft-constraint parameters per row:
  x      = pos - margin
  imp(x) = solimp spline, clamped to (1e-4, 1 - 1e-4)
  aref   = -B (J qvel) - K imp x        (friction rows: no position term)
  R      = max(1 - imp, 1e-4) / imp * diagApprox

Ported: friction-loss rows, joint-limit rows, elliptic cone blocks, the
culled pyramidal rows of a uniform condim > 1 and, for every other set of
simple slots (frictionless condim-1 slots beside elliptic cones, or a
pyramidal model of mixed condims), the reference's unculled per-slot rows:
one row per condim-1 slot and 2 (condim - 1) per other slot, in slot order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import (
    CONE_ELLIPTIC,
    GEOM_HFIELD,
    DeviceModel,
    Model,
)
from gym_quadruped_tpu_torch.physics.collision import Contacts, contact_layout, make_frame
from gym_quadruped_tpu_torch.physics.kinematics import Kin, ancestor_dof_mask, spatial_origin


# ---------------------------------------------------------------------------------
# static layout
# ---------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ConstraintLayout:
    """Static constraint structure (numpy)."""

    fl_dofs: np.ndarray        # (nfl,)
    lim_jnts: np.ndarray       # (nlim,)
    n_fl: int
    n_lim: int
    elliptic: bool
    # contact slots (parallel to the collision slot order)
    con_condim: np.ndarray     # (S,)
    con_mu: np.ndarray         # (S, 5)
    con_solref: np.ndarray     # (S, 2)
    con_solimp: np.ndarray     # (S, 5)
    con_margin: np.ndarray     # (S,)
    con_incl: np.ndarray       # (S,) inclusion threshold: margin, 0 for hfield pairs
    con_body: np.ndarray       # (S,) robot body of geom2
    con_body1: np.ndarray      # (S,) body of geom1 (0 for world pairs)
    con_geom1: np.ndarray      # (S,) world geom id
    con_geom2: np.ndarray      # (S,) robot geom id
    con_prio: np.ndarray       # (S,) -1 geom1 wins, +1 geom2 wins, 0 equal
    # derived
    n_simple: int              # total simple rows
    simple_unilateral: np.ndarray  # (n_simple,) bool (False: friction-loss row)
    con_is_cone: np.ndarray    # (S,) bool, handled as a cone block
    cone_slots: np.ndarray     # indices of cone slots
    simple_con_slots: np.ndarray  # indices of slots emitted as simple rows
    cone_dim_mask: np.ndarray  # (n_cone, 6)


@functools.lru_cache(maxsize=64)
def constraint_layout(m: Model) -> ConstraintLayout:
    fl_dofs = np.where(np.asarray(m.dof_frictionloss) > 0)[0].astype(np.int32)
    lim_jnts = np.where(np.asarray(m.jnt_limited))[0].astype(np.int32)
    elliptic = int(m.cone) == CONE_ELLIPTIC

    condims, mus, solrefs, solimps, margins, incls = [], [], [], [], [], []
    bodies, bodies1, geom1s, geom2s, prios = [], [], [], [], []
    for spec in contact_layout(m):
        p1 = int(m.geom_priority[spec.geom1])
        p2 = int(m.geom_priority[spec.geom2])
        prio = 0 if p1 == p2 else (-1 if p1 > p2 else 1)
        hfield_pair = int(m.geom_type[spec.geom1]) == GEOM_HFIELD
        for _ in range(spec.ncon):
            condims.append(spec.condim)
            mus.append(spec.friction)
            solrefs.append(spec.solref)
            solimps.append(spec.solimp)
            margins.append(spec.margin)
            incls.append(0.0 if hfield_pair else spec.margin)
            bodies.append(int(m.geom_bodyid[spec.geom2]))
            bodies1.append(int(m.geom_bodyid[spec.geom1]))
            geom1s.append(spec.geom1)
            geom2s.append(spec.geom2)
            prios.append(prio)
    condims = np.array(condims, np.int32)
    S = len(condims)
    is_cone = np.array([elliptic and cd > 1 for cd in condims], bool)
    cone_slots = np.where(is_cone)[0].astype(np.int32)
    simple_slots = np.where(~is_cone)[0].astype(np.int32)

    n_simple = len(fl_dofs) + len(lim_jnts)
    for s in simple_slots:
        cd = int(condims[s])
        n_simple += 1 if cd == 1 else 2 * (cd - 1)
    unilateral = np.ones(n_simple, bool)
    unilateral[:len(fl_dofs)] = False

    cone_dim_mask = np.zeros((len(cone_slots), 6), np.float64)
    for i, s in enumerate(cone_slots):
        cone_dim_mask[i, :int(condims[s])] = 1.0

    return ConstraintLayout(
        fl_dofs=fl_dofs, lim_jnts=lim_jnts,
        n_fl=len(fl_dofs), n_lim=len(lim_jnts), elliptic=elliptic,
        con_condim=condims,
        con_mu=np.array(mus, np.float64).reshape(S, 5),
        con_solref=np.array(solrefs, np.float64).reshape(S, 2),
        con_solimp=np.array(solimps, np.float64).reshape(S, 5),
        con_margin=np.array(margins, np.float64).reshape(S),
        con_incl=np.array(incls, np.float64).reshape(S),
        con_body=np.array(bodies, np.int32),
        con_body1=np.array(bodies1, np.int32),
        con_geom1=np.array(geom1s, np.int32),
        con_geom2=np.array(geom2s, np.int32),
        con_prio=np.array(prios, np.int32),
        n_simple=n_simple,
        simple_unilateral=unilateral,
        con_is_cone=is_cone, cone_slots=cone_slots,
        simple_con_slots=simple_slots,
        cone_dim_mask=cone_dim_mask)


@functools.lru_cache(maxsize=64)
def con_mask_table(m: Model, lay: ConstraintLayout) -> np.ndarray:
    """(S, nv) signed dof masks per slot, mask(body2) - mask(body1): the
    contact Jacobian is the relative point-velocity Jacobian, so dofs shared
    by both bodies cancel."""
    m2 = np.stack([ancestor_dof_mask(m, int(b)) for b in lay.con_body])
    m1 = np.stack([ancestor_dof_mask(m, int(b)) for b in lay.con_body1])
    return m2 - m1


# ---------------------------------------------------------------------------------
# soft-constraint scalar model
# ---------------------------------------------------------------------------------

def impedance(solimp, x):
    """Position-dependent impedance d(x) (solimp spline), clamped to (1e-4, 1-1e-4)."""
    d0, d1, width, mid, power = solimp.unbind(-1)
    y = torch.clamp_max(x.abs() / torch.clamp_min(width, 1e-12), 1.0)
    lo = mid ** (1.0 - power) * y ** power
    hi = 1.0 - (1.0 - mid) ** (1.0 - power) * (1.0 - y) ** power
    z = torch.where(y < mid, lo, hi)
    return torch.clamp(d0 + z * (d1 - d0), 1e-4, 1.0 - 1e-4)


def kb(solref, solimp):
    """Stiffness K and damping B from solref (negative solref = direct spec)."""
    tc, dr = solref[..., 0], solref[..., 1]
    d1 = solimp[..., 1]
    K_std = 1.0 / torch.clamp_min(d1 * d1 * tc * tc * dr * dr, 1e-12)
    B_std = 2.0 / torch.clamp_min(d1 * tc, 1e-12)
    K_dir = -tc / torch.clamp_min(d1 * d1, 1e-12)
    B_dir = -dr / torch.clamp_min(d1, 1e-12)
    std = torch.minimum(tc, dr) > 0
    return torch.where(std, K_std, K_dir), torch.where(std, B_std, B_dir)


# ---------------------------------------------------------------------------------
# assembled rows
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class Efc:
    """Assembled constraint rows, each with a leading env axis B: simple rows
    (friction loss, limits, then the culled pyramidal contact rows) plus the
    culled cone blocks."""

    J: torch.Tensor             # (B, ns, nv)
    aref: torch.Tensor          # (B, ns)
    R: torch.Tensor             # (B, ns)
    active: torch.Tensor        # (B, ns) bool
    frictionloss: torch.Tensor  # (B, ns)
    con_J: torch.Tensor         # (B, C, 6, nv)
    con_aref: torch.Tensor      # (B, C, 6)
    con_R: torch.Tensor         # (B, C, 6)
    con_active: torch.Tensor    # (B, C) bool
    cone_mu: torch.Tensor       # (B, C, 5)
    cone_dim_mask: torch.Tensor  # (B, C, 6)
    cone_dist: torch.Tensor     # (B, C)
    cone_sel: torch.Tensor      # (B, C) int64 cone-slot index of each block
    # (B, Kp) int64, with cone = pyramidal: the index into the layout's
    # simple_con_slots of each culled slot, whose 2 (condim - 1) rows follow
    # the friction-loss and limit rows in J; None otherwise
    pyr_sel: torch.Tensor | None = None


def _point_jacobians_dyn(kin: Kin, cdof: torch.Tensor, pos: torch.Tensor,
                         masks: torch.Tensor):
    """Translational and rotational Jacobians (B, K, 3, nv) of K points per
    env, each with its own signed dof mask (B, K, nv)."""
    omega = cdof[..., :3]                                        # (B, nv, 3)
    rel = pos - spatial_origin(kin)[:, None, :]                  # (B, K, 3)
    vp = cdof[:, None, :, 3:] + torch.linalg.cross(
        omega[:, None].expand(-1, rel.shape[1], -1, -1), rel[:, :, None, :])
    masks_j = masks[..., None]
    jacp = (vp * masks_j).transpose(2, 3)
    jacr = (omega[:, None] * masks_j).transpose(2, 3)
    return jacp, jacr


def _point_jacobians(dm: DeviceModel, kin: Kin, cdof: torch.Tensor, pos: torch.Tensor,
                     body_ids) -> tuple[torch.Tensor, torch.Tensor]:
    """Translational and rotational Jacobians (B, k, 3, nv) of k points per
    env (pos (B, k, 3)), the i-th on the static body body_ids[i]."""
    ids = tuple(int(b) for b in body_ids)
    masks = dm.const(('point_masks', ids),
                     lambda: np.stack([ancestor_dof_mask(dm.m, b) for b in ids]))
    return _point_jacobians_dyn(kin, cdof, pos, masks.expand(pos.shape[0], -1, -1))


def runtime_con_mu(dm: DeviceModel, geom_friction: torch.Tensor) -> torch.Tensor:
    """Per-slot friction (B, S, 5) from per-env geom friction tables (B,
    ngeom, 3), by MuJoCo's rule for a pair (the geom of higher priority
    wins, else the elementwise max), so that per-env friction randomisation
    is a gather."""
    lay = constraint_layout(dm.m)
    f1 = geom_friction[:, dm.const('con_geom1', lambda: lay.con_geom1)]   # (B, S, 3)
    f2 = geom_friction[:, dm.const('con_geom2', lambda: lay.con_geom2)]
    prio = dm.const('con_prio', lambda: lay.con_prio)[:, None]
    fri3 = torch.where(prio < 0, f1, torch.where(prio > 0, f2, torch.maximum(f1, f2)))
    # (sliding, sliding, torsional, rolling, rolling)
    return fri3[..., dm.const('mu_columns', lambda: np.array([0, 0, 1, 2, 2]))]


@dataclasses.dataclass
class _Culled:
    """The contact slots of one kind (cone or pyramidal), culled to the
    nearest `max_cone` per env: their selection, contact-frame rows and
    soft-constraint scalars, each (B, K, ...)."""

    sel: torch.Tensor      # (B, K) indices into the kind's slot list
    dist: torch.Tensor     # (B, K)
    dirs: torch.Tensor     # (B, K, 6, nv) frame rows: normal, t1, t2, then rotational
    vel6: torch.Tensor     # (B, K, 6) dirs @ qvel
    x: torch.Tensor        # (B, K) dist - margin
    imp: torch.Tensor
    K: torch.Tensor
    Bd: torch.Tensor
    rimp: torch.Tensor     # max(1 - imp, 1e-4) / imp
    include: torch.Tensor  # (B, K) bool, dist < inclusion threshold
    table: object          # table(name, make): a static (S_kind, ...) table at sel
    slots: torch.Tensor    # (S_kind,) the kind's slots on the device


def _mu_at(c: _Culled, con_mu, static: np.ndarray) -> torch.Tensor:
    """(B, K, 5) friction of the culled slots: the model's (`static`, the
    kind's rows of the layout's con_mu) without `con_mu`, else con_mu (S, 5)
    or (B, S, 5) gathered at them."""
    if con_mu is None:
        return c.table('mu', lambda: static)
    mu = con_mu.to(c.dist.dtype).expand(c.sel.shape[0], -1, -1)[:, c.slots]
    return torch.gather(mu, 1, c.sel[..., None].expand(-1, -1, 5))


def _culled_slots(dm: DeviceModel, kin: Kin, cdof, qvel, contacts: Contacts, slots,
                  kind: str, max_cone: int | None) -> _Culled:
    """The `max_cone` nearest of the slots `slots` in ascending distance
    (all of them without a cap), the lower slot first among equal distances,
    as jax.lax.top_k orders them (torch.topk promises no order among ties)."""
    m = dm.m
    lay = constraint_layout(m)
    B = qvel.shape[0]
    slots_t = dm.const((kind, 'slots'), lambda: slots)
    feat = contacts.feat[:, :, slots_t]                        # (B, 7, S_kind)
    if max_cone is not None and max_cone < len(slots):
        sel = torch.sort(feat[:, 0], dim=1, stable=True).indices[:, :max_cone]
    else:
        sel = torch.arange(len(slots), device=qvel.device).expand(B, len(slots))
    feat = torch.gather(feat, 2, sel[:, None, :].expand(B, 7, sel.shape[1]))
    dist = feat[:, 0]
    pos = feat[:, 1:4].transpose(1, 2)
    n = feat[:, 4:7].transpose(1, 2)

    def table(name, make):
        """A static per-slot table (S_kind, ...) taken at sel."""
        return dm.const((kind, name), make)[sel]

    masks = table('mask', lambda: con_mask_table(m, lay)[slots])
    margin = table('margin', lambda: lay.con_margin[slots])
    solimp = table('solimp', lambda: lay.con_solimp[slots])
    solref = table('solref', lambda: lay.con_solref[slots])
    incl = table('incl', lambda: lay.con_incl[slots])

    frame = make_frame(n)                                      # (B, K, 3, 3)
    jacp, jacr = _point_jacobians_dyn(kin, cdof, pos, masks)
    dirs = torch.cat([frame @ jacp, frame @ jacr], 2)          # (B, K, 6, nv)
    vel6 = (dirs @ qvel[:, None, :, None])[..., 0]             # (B, K, 6)
    x = dist - margin
    imp = impedance(solimp, x)
    K, Bd = kb(solref, solimp)
    return _Culled(sel=sel, dist=dist, dirs=dirs, vel6=vel6, x=x, imp=imp, K=K, Bd=Bd,
                   rimp=torch.clamp_min(1.0 - imp, 1e-4) / imp, include=dist < incl,
                   table=table, slots=slots_t)


def pyramidal_rows(lay: ConstraintLayout, max_cone: int | None = None) -> tuple[int, int, int]:
    """Where `make_efc` puts the culled pyramidal contact rows among the
    simple rows: (the first row, rows per slot, slots kept). They follow the
    friction-loss and limit rows, 2 (condim - 1) rows for each of the
    `max_cone` nearest slots (every slot without a cap). A layout whose
    simple slots are emitted unculled (`culled_pyramidal` false) has no
    such rows: (first, 0, 0); its rows are `simple_slot_rows`."""
    ss = lay.simple_con_slots
    if not len(ss) or not culled_pyramidal(lay):
        return lay.n_fl + lay.n_lim, 0, 0
    kept = len(ss) if max_cone is None else min(len(ss), max_cone)
    return lay.n_fl + lay.n_lim, 2 * (int(lay.con_condim[ss[0]]) - 1), kept


def culled_pyramidal(lay: ConstraintLayout) -> bool:
    """True when the simple contact slots share one condim > 1 (a pyramidal
    model such as aliengo): `make_efc` culls them to the `max_cone`
    nearest. Any other set of simple slots (condim-1 slots beside elliptic
    cones, or a pyramidal model of mixed condims) is emitted unculled, slot
    by slot."""
    cds = set(lay.con_condim[lay.simple_con_slots].tolist())
    return len(cds) == 1 and min(cds) > 1


@functools.lru_cache(maxsize=64)
def simple_slot_rows(lay: ConstraintLayout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The unculled per-slot rows, in slot order: for each row, its slot's
    index into the layout's simple_con_slots, its friction direction i (0
    for a condim-1 slot's one row) and its sign (0 for that row, else +1
    then -1 for each i)."""
    slot, fric, sign = [], [], []
    for k, s in enumerate(lay.simple_con_slots):
        cd = int(lay.con_condim[s])
        if cd == 1:
            slot.append(k), fric.append(0), sign.append(0.0)
            continue
        for i in range(cd - 1):
            for sg in (1.0, -1.0):
                slot.append(k), fric.append(i), sign.append(sg)
    return (np.array(slot, np.int64), np.array(fric, np.int64), np.array(sign, np.float64))


def _per_slot_rows(dm: DeviceModel, kin: Kin, cdof, qvel, contacts: Contacts, con_mu,
                   J_rows, aref_rows, R_rows, act_rows, fl_rows):
    """Append the unculled per-slot rows of every simple contact slot
    (`simple_slot_rows`) as one gather over their row tables: J = dir_0 +
    sign mu_i dir_(1+i), R = rimp inv_t for a condim-1 row and rimp 2 (inv_t
    + mu_i^2 fri_inv_i) for the others, each row with its slot's include."""
    m = dm.m
    lay = constraint_layout(m)
    ss = lay.simple_con_slots
    B, nv = qvel.shape
    p = _culled_slots(dm, kin, cdof, qvel, contacts, ss, 'simple', None)
    slot_np, fric_np, sign_np = simple_slot_rows(lay)
    slot = dm.const(('simple', 'row_slot'), lambda: slot_np)
    fric = dm.const(('simple', 'row_fric'), lambda: fric_np)
    sign = dm.const(('simple', 'row_sign'), lambda: sign_np)
    frictionless = dm.const(('simple', 'row_cd1'), lambda: sign_np == 0.0)
    inv_t = dm.const(('simple', 'inv_t'), lambda: m.body_invweight0[lay.con_body[ss], 0]
                     + m.body_invweight0[lay.con_body1[ss], 0])[slot]
    inv_r = dm.const(('simple', 'inv_r'), lambda: m.body_invweight0[lay.con_body[ss], 1]
                     + m.body_invweight0[lay.con_body1[ss], 1])[slot]
    mu = _mu_at(p, con_mu, lay.con_mu[ss])[:, slot]                    # (B, R, 5)
    mu_i = torch.gather(mu, 2, fric.expand(B, -1)[..., None])[..., 0]  # (B, R)
    coef = sign * mu_i
    d_0, d_i = p.dirs[:, slot, 0], p.dirs[:, slot, 1 + fric]          # (B, R, nv)
    v_0, v_i = p.vel6[:, slot, 0], p.vel6[:, slot, 1 + fric]          # (B, R)
    fri_inv = torch.where(fric < 2, inv_t, inv_r)   # (t, t, r, r, r)
    rimp = p.rimp[:, slot]
    J_rows.append(torch.where(frictionless[:, None], d_0, d_0 + coef[..., None] * d_i))
    aref_rows.append(-p.Bd[:, slot] * torch.where(frictionless, v_0, v_0 + coef * v_i)
                     - (p.K * p.imp * p.x)[:, slot])
    R_rows.append(torch.where(frictionless, rimp * inv_t,
                              rimp * (2.0 * (inv_t + mu_i * mu_i * fri_inv))))
    act_rows.append(p.include[:, slot])
    fl_rows.append(qvel.new_zeros(B, len(slot_np)))


def make_efc(dm: DeviceModel, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
             contacts: Contacts, cdof: torch.Tensor, con_mu: torch.Tensor | None = None,
             max_cone: int | None = None) -> Efc:
    """Assemble constraint rows for B envs. With `max_cone`, only the
    max_cone nearest cone slots of each env get Jacobians and rows (exact
    whenever no more slots than that touch); the same cap culls the
    pyramidal contact slots of a model with cone = pyramidal. `con_mu`, (S,
    5) or per env (B, S, 5) (`runtime_con_mu`), replaces the model's
    per-slot friction in both kinds of rows."""
    m = dm.m
    lay = constraint_layout(m)
    nv = m.nv
    B = qpos.shape[0]
    dtype = qpos.dtype
    ss = lay.simple_con_slots
    J_rows, aref_rows, R_rows, act_rows, fl_rows = [], [], [], [], []

    # ---- 1. dof friction loss --------------------------------------------------------
    if lay.n_fl:
        dofs = dm.const('fl_dofs', lambda: lay.fl_dofs)
        solref = dm.const('fl_solref', lambda: m.dof_solref[lay.fl_dofs])
        solimp = dm.const('fl_solimp', lambda: m.dof_solimp[lay.fl_dofs])
        imp = impedance(solimp, torch.zeros_like(solimp[:, 0]))
        _, Bd = kb(solref, solimp)
        J_rows.append(dm.const('fl_J', lambda: np.eye(nv)[lay.fl_dofs]).expand(B, -1, -1))
        aref_rows.append(-Bd * qvel[:, dofs])
        R_rows.append((torch.clamp_min(1.0 - imp, 1e-4) / imp
                       * dm.dof_invweight0[dofs]).expand(B, -1))
        act_rows.append(torch.ones(B, lay.n_fl, dtype=torch.bool, device=qpos.device))
        fl_rows.append(dm.dof_frictionloss[dofs].expand(B, -1))

    # ---- 2. joint limits ---------------------------------------------------------------
    if lay.n_lim:
        jids = lay.lim_jnts
        qadr = dm.const('lim_qadr', lambda: m.jnt_qposadr[jids])
        dadr = dm.const('lim_dadr', lambda: m.jnt_dofadr[jids])
        jrange = dm.const('lim_range', lambda: m.jnt_range[jids])
        q = qpos[:, qadr]
        dist_lo = q - jrange[:, 0]
        dist_hi = jrange[:, 1] - q
        low_side = dist_lo < dist_hi
        dist = torch.where(low_side, dist_lo, dist_hi)
        sign = torch.where(low_side, 1.0, -1.0).to(dtype)
        Jl = sign[..., None] * dm.const('lim_J', lambda: np.eye(nv)[m.jnt_dofadr[jids]])
        margin = dm.const('lim_margin', lambda: m.jnt_margin[jids])
        solref = dm.const('lim_solref', lambda: m.jnt_solref[jids])
        solimp = dm.const('lim_solimp', lambda: m.jnt_solimp[jids])
        x = dist - margin
        imp = impedance(solimp, x)
        K, Bd = kb(solref, solimp)
        J_rows.append(Jl)
        aref_rows.append(-Bd * (sign * qvel[:, dadr]) - K * imp * x)
        R_rows.append(torch.clamp_min(1.0 - imp, 1e-4) / imp * dm.dof_invweight0[dadr])
        act_rows.append(dist < margin)
        fl_rows.append(torch.zeros_like(dist))

    # ---- 2b. simple contact rows: per slot 2 (condim - 1) one-sided rows, J =
    # dir_0 +- mu_i dir_i, in the order (i = 0, +), (i = 0, -), (i = 1, +), ...,
    # culled to the nearest max_cone slots with one condim > 1 (pyramidal);
    # else every simple slot in slot order, a condim-1 slot's one row J = dir_0
    pyr_sel = None
    if len(ss) and not culled_pyramidal(lay):
        _per_slot_rows(dm, kin, cdof, qvel, contacts, con_mu, J_rows, aref_rows, R_rows,
                       act_rows, fl_rows)
    elif len(ss):
        _, nrows, _ = pyramidal_rows(lay)
        p = _culled_slots(dm, kin, cdof, qvel, contacts, ss, 'pyr', max_cone)
        inv_t = p.table('inv_t', lambda: m.body_invweight0[lay.con_body[ss], 0]
                        + m.body_invweight0[lay.con_body1[ss], 0])
        inv_r = p.table('inv_r', lambda: m.body_invweight0[lay.con_body[ss], 1]
                        + m.body_invweight0[lay.con_body1[ss], 1])
        mu = _mu_at(p, con_mu, lay.con_mu[ss])
        fri_inv = (inv_t, inv_t, inv_r, inv_r, inv_r)
        rows_J, rows_aref, rows_R = [], [], []
        for i in range(nrows // 2):
            mu_i = mu[..., i]
            diag = 2.0 * (inv_t + mu_i * mu_i * fri_inv[i])
            for sgn in (1.0, -1.0):
                rows_J.append(p.dirs[:, :, 0] + sgn * mu_i[..., None] * p.dirs[:, :, 1 + i])
                vel = p.vel6[..., 0] + sgn * mu_i * p.vel6[..., 1 + i]
                rows_aref.append(-p.Bd * vel - p.K * p.imp * p.x)
                rows_R.append(p.rimp * diag)
        J_rows.append(torch.stack(rows_J, 2).reshape(B, -1, nv))
        aref_rows.append(torch.stack(rows_aref, 2).reshape(B, -1))
        R_rows.append(torch.stack(rows_R, 2).reshape(B, -1))
        act_rows.append(p.include.repeat_interleave(nrows, 1))
        fl_rows.append(qpos.new_zeros(B, p.sel.shape[1] * nrows))
        pyr_sel = p.sel

    # ---- 3. elliptic cone blocks, culled to the nearest max_cone slots ----------------
    C_all = len(lay.cone_slots)
    if C_all:
        cs = lay.cone_slots
        c = _culled_slots(dm, kin, cdof, qvel, contacts, cs, 'cone', max_cone)
        sel, dist_c = c.sel, c.dist
        inv_tc = c.table('inv_t', lambda: m.body_invweight0[lay.con_body[cs], 0]
                         + m.body_invweight0[lay.con_body1[cs], 0])
        mu = _mu_at(c, con_mu, lay.con_mu[cs])
        dim_mask = c.table('dim_mask', lambda: lay.cone_dim_mask)
        aref_nc = -c.Bd * c.vel6[..., 0] - c.K * c.imp * c.x

        con_J = c.dirs * dim_mask[..., None]
        aref_f = -c.Bd[..., None] * c.vel6[..., 1:]              # friction: no K term
        con_aref = torch.cat([aref_nc[..., None], aref_f], -1) * dim_mask
        # R: normal = rimp inv_t; friction i = rimp inv_t (mu0/mu_i)^2 / impratio
        R_fric = (c.rimp[..., None] * inv_tc[..., None]
                  * (mu[..., :1] / torch.clamp_min(mu, 1e-12)) ** 2 / m.impratio)
        con_R = torch.cat([(c.rimp * inv_tc)[..., None], R_fric], -1)
        con_R = torch.where(dim_mask > 0, con_R, 1.0)
        con_active = c.include
    else:
        z = qpos.new_zeros
        con_J, con_aref, con_R = z(B, 0, 6, nv), z(B, 0, 6), qpos.new_ones(B, 0, 6)
        con_active = torch.zeros(B, 0, dtype=torch.bool, device=qpos.device)
        mu, dim_mask, dist_c = z(B, 0, 5), z(B, 0, 6), z(B, 0)
        sel = torch.zeros(B, 0, dtype=torch.int64, device=qpos.device)

    if J_rows:
        J = torch.cat(J_rows, 1)
        aref, R = torch.cat(aref_rows, 1), torch.cat(R_rows, 1)
        active, fl = torch.cat(act_rows, 1), torch.cat(fl_rows, 1)
    else:
        J = qpos.new_zeros(B, 0, nv)
        aref, R, fl = qpos.new_zeros(B, 0), qpos.new_zeros(B, 0), qpos.new_zeros(B, 0)
        active = torch.zeros(B, 0, dtype=torch.bool, device=qpos.device)
    return Efc(J=J, aref=aref, R=R, active=active, frictionloss=fl,
               con_J=con_J, con_aref=con_aref, con_R=con_R, con_active=con_active,
               cone_mu=mu, cone_dim_mask=dim_mask, cone_dist=dist_c, cone_sel=sel,
               pyr_sel=pyr_sel)


def scatter_cone_forces(cone_sel: torch.Tensor, f_cone: torch.Tensor, C_all: int):
    """(B, K) slot indices and (B, K, 6) culled forces -> (B, C_all, 6)
    forces on the full slot axis (zero on culled slots)."""
    out = f_cone.new_zeros(f_cone.shape[0], C_all, f_cone.shape[2])
    return out.scatter_(1, cone_sel[..., None].expand_as(f_cone), f_cone)
