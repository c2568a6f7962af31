"""Periodic gait scheduling: per-leg contact flags over the MPC horizon.

Counterpart of gym_quadruped_tpu/mpc/gait.py. Every function is a pure
function of the time, batched over envs: `t` is (B,), phases (B, 4), the
schedule (B, H, 4). The `duty >= 1` branches test the static config in
Python, never a tensor. Each takes the config's phase offsets as a tensor
(`offsets`, (4,)) where the caller keeps one on the device; without it they
are copied from the config to `t`'s device on each call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# phase offsets (FL, FR, RL, RR) and duty factor per gait
GAITS = {
    'trot': (np.array([0.0, 0.5, 0.5, 0.0]), 0.6),
    'walk': (np.array([0.0, 0.5, 0.75, 0.25]), 0.8),
    'pace': (np.array([0.0, 0.5, 0.0, 0.5]), 0.6),
    'bound': (np.array([0.0, 0.0, 0.5, 0.5]), 0.6),
    'pronk': (np.array([0.0, 0.0, 0.0, 0.0]), 0.5),
    'stand': (np.array([0.0, 0.0, 0.0, 0.0]), 1.0),
}


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    name: str = 'trot'
    period: float = 0.5          # gait cycle length [s]
    offsets: tuple = None        # per-leg phase offsets, defaults from GAITS
    duty: float = None           # stance fraction, defaults from GAITS

    def resolved(self):
        off, duty = GAITS[self.name]
        return (np.asarray(self.offsets) if self.offsets is not None else off,
                self.duty if self.duty is not None else duty)


def gait_offsets(cfg: GaitConfig, like: torch.Tensor) -> torch.Tensor:
    """(4,) the config's phase offsets in `like`'s dtype, on its device."""
    return torch.as_tensor(cfg.resolved()[0], dtype=like.dtype).to(like.device)


def leg_phases(cfg: GaitConfig, t: torch.Tensor, offsets=None) -> torch.Tensor:
    """(B, 4) phase in [0, 1) of each leg at the times t (B,)."""
    if offsets is None:
        offsets = gait_offsets(cfg, t)
    # jnp.mod is the floored remainder: torch.remainder, not torch.fmod
    return torch.remainder(t[:, None] / cfg.period + offsets, 1.0)


def contact_schedule(cfg: GaitConfig, t: torch.Tensor, horizon: int, dt: float,
                     offsets=None) -> torch.Tensor:
    """(B, horizon, 4) stance flags over the lookahead starting at the times
    t (B,)."""
    _, duty = cfg.resolved()
    if offsets is None:
        offsets = gait_offsets(cfg, t)
    ks = torch.arange(horizon, dtype=t.dtype, device=t.device) * dt
    phases = torch.remainder((t[:, None] + ks)[..., None] / cfg.period + offsets, 1.0)
    if duty >= 1.0:
        return torch.ones_like(phases)
    return (phases < duty).to(phases.dtype)


def swing_phase(cfg: GaitConfig, t: torch.Tensor, offsets=None) -> torch.Tensor:
    """(B, 4) normalized swing progress in [0, 1] (0 at liftoff, 1 at
    touchdown); 0 during stance."""
    _, duty = cfg.resolved()
    ph = leg_phases(cfg, t, offsets)
    if duty >= 1.0:
        return torch.zeros_like(ph)
    s = (ph - duty) / max(1.0 - duty, 1e-6)
    return torch.clamp(s, 0.0, 1.0) * (ph >= duty)
