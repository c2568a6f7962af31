"""Contact forces, batched over envs: per-slot world forces and per-foot
aggregates.

Counterpart of gym_quadruped_tpu/physics/forces.py (the reference env's
mj_contactForce scan, quadruped_env.py:799-872). Solver forces act on the
robot geom (geom2); a slot's contact-frame force f (rows n, t1, t2) is
frame' f in the world; pyramidal rows decode as mju_decodePyramid does
(normal = the sum of the edges, tangent i = mu_i (f+_i - f-_i)).

As in the reference, the pyramidal decode takes the model's friction (the
layout's con_mu), not a per-env table that `make_efc` was given
(`runtime_con_mu`): with a friction range, the tangential forces of the
pyramidal models use the model's mu.

"Foot contact" is keyed by body, as the reference keys it: any contact
between the world and the body that owns a foot geom counts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import DeviceModel, Model
from gym_quadruped_tpu_torch.physics.collision import make_frame
from gym_quadruped_tpu_torch.physics.constraints import ConstraintLayout, constraint_layout


@functools.lru_cache(maxsize=64)
def simple_row_table(lay: ConstraintLayout) -> np.ndarray:
    """(S, 2) [first row, rows] of each slot emitted as simple rows without a
    cull, -1 for cone slots: after the friction-loss and limit rows, one row
    per condim-1 slot and 2 (condim - 1) per other slot, in slot order."""
    table = np.full((len(lay.con_condim), 2), -1, np.int64)
    row = lay.n_fl + lay.n_lim
    for s in lay.simple_con_slots:
        cd = int(lay.con_condim[s])
        n = 1 if cd == 1 else 2 * (cd - 1)
        table[s] = (row, n)
        row += n
    return table


def _decode_pyramid(edges: torch.Tensor, mu: torch.Tensor, cd: int) -> torch.Tensor:
    """(..., 3) contact-frame force from the (..., 2 (cd - 1)) edge forces of
    slots of condim cd and their friction (..., 5)."""
    tangents = [(edges[..., 2 * i] - edges[..., 2 * i + 1]) * mu[..., i] for i in range(cd - 1)]
    tangents += [torch.zeros_like(edges[..., 0])] * (2 - len(tangents))
    return torch.stack([edges.sum(-1), tangents[0], tangents[1]], -1)


def slot_forces_world(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B, S, 3) world-frame contact force on the robot geom of each slot
    (zero on a slot the solve did not take)."""
    return torch.einsum('bsij,bsi->bsj', make_frame(fwd.contacts.normal),
                        _slot_forces_frame(dm, fwd))


def _slot_forces_frame(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B, S, 3) contact-frame force (n, t1, t2) of each slot."""
    m = dm.m
    lay = constraint_layout(m)
    S = len(lay.con_condim)
    f3 = fwd.qacc.new_zeros(fwd.qacc.shape[0], S, 3)
    if S == 0:
        return f3
    if len(lay.cone_slots):   # elliptic blocks: the first 3 rows are the frame force
        f3[:, dm.const('cone_slots', lambda: lay.cone_slots)] = fwd.f_cone[..., :3]
    ss = lay.simple_con_slots
    if fwd.efc.pyr_sel is not None:
        # the culled pyramidal rows: 2 (condim - 1) per selected slot, in
        # pyr_sel order, after the friction-loss and limit rows
        sel = fwd.efc.pyr_sel                                      # (B, Kp)
        cd = int(lay.con_condim[ss[0]])
        edges = fwd.efc_force[:, lay.n_fl + lay.n_lim:].reshape(*sel.shape, 2 * (cd - 1))
        mu = dm.const(('pyr', 'mu'), lambda: lay.con_mu[ss])[sel]   # the model's mu
        slots = dm.const(('pyr', 'slots'), lambda: ss)[sel]
        f3 = f3.scatter(1, slots[..., None].expand(-1, -1, 3), _decode_pyramid(edges, mu, cd))
    elif len(ss):
        # every simple slot, unculled: the table's rows, one condim at a time
        table = simple_row_table(lay)
        for cd in sorted(set(lay.con_condim[ss].tolist())):
            sl = ss[lay.con_condim[ss] == cd]
            rows = dm.const(('simple_rows', cd), lambda: table[sl, :1] + np.arange(table[sl[0], 1]))
            edges = fwd.efc_force[:, rows]                         # (B, n, rows per slot)
            at = dm.const(('simple_slots', cd), lambda: sl)
            if cd == 1:
                f3[:, at, 0] = edges[..., 0]
            else:
                mu = dm.const(('simple_mu', cd), lambda: lay.con_mu[sl])
                f3[:, at] = _decode_pyramid(edges, mu, cd)
    return f3


@functools.lru_cache(maxsize=64)
def feet_slot_mask(m: Model) -> np.ndarray:
    """(4, S) 0/1: slot s is a contact between the world and the body of foot
    f (FL, FR, RL, RR). Self-contacts never count, as in the reference
    (quadruped_env.py:838-844)."""
    lay = constraint_layout(m)
    world = np.asarray(lay.con_body1) == 0
    return ((np.asarray(lay.con_body)[None, :] == np.asarray(m.feet_body_id)[:, None])
            & world[None, :]).astype(np.float64)


def active_slots(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B, S) bool: the slot is in the contact set (dist below its inclusion
    threshold, mjData.contact)."""
    lay = constraint_layout(dm.m)
    return fwd.contacts.dist < dm.const('con_incl', lambda: lay.con_incl)


def _feet_slots(dm: DeviceModel):
    """The slots of any foot (F,), the feet's mask over them (4, F) and
    their inclusion thresholds (F,): the feet's sums need no other slot
    (go2/flat: 52 of 1,180)."""
    mask = feet_slot_mask(dm.m)
    cols = np.flatnonzero(mask.any(0))
    return (dm.const('feet_slots', lambda: cols), dm.const('feet_slot_mask', lambda: mask[:, cols]),
            dm.const('feet_incl', lambda: constraint_layout(dm.m).con_incl[cols]))


def feet_contact_state(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B, 4) bool FL, FR, RL, RR (reference feet_contact_state,
    quadruped_env.py:799)."""
    cols, mask, incl = _feet_slots(dm)
    return ((fwd.contacts.dist[:, cols] < incl)[:, None, :] & (mask > 0)).any(-1)


def feet_contact_forces(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B, 4, 3) world ground-reaction force of each foot (the sum over its
    slots)."""
    cols, mask, _ = _feet_slots(dm)
    f3 = _slot_forces_frame(dm, fwd)[:, cols]
    fw = torch.einsum('bsij,bsi->bsj', make_frame(fwd.contacts.normal[:, cols]), f3)
    return torch.einsum('fs,bsj->bfj', mask, fw)


def invalid_contact(dm: DeviceModel, fwd) -> torch.Tensor:
    """(B,) bool: a contact between the world and a robot body that is no
    foot's (reference _check_for_invalid_contacts, quadruped_env.py:1228-1248;
    self-contacts are ignored)."""
    lay = constraint_layout(dm.m)
    nonfoot = dm.const('nonfoot_world_slots', lambda: ~np.any(feet_slot_mask(dm.m) > 0, axis=0)
                       & (np.asarray(lay.con_body1) == 0))
    return (active_slots(dm, fwd) & nonfoot).any(-1)
