"""LegsAttr: a named per-leg container (FL, FR, RL, RR).

Counterpart of gym_quadruped_tpu/utils/legs.py, the reference's LegsAttr
(utils/quadruped_utils.py:16-129), for the single-env gym surface
(`env.gym_adapter.QuadrupedGymEnv`). The batched path does not use it: its
leg quantities are (B, 4, ...) tensors in the fixed FL, FR, RL, RR order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

LEG_ORDER = ('FL', 'FR', 'RL', 'RR')


@dataclasses.dataclass
class LegsAttr:
    """One attribute of each leg of a quadruped."""

    FL: Any
    FR: Any
    RL: Any
    RR: Any

    def to_list(self, order=LEG_ORDER):
        return [getattr(self, leg) for leg in order]

    def __getitem__(self, key):
        assert key in LEG_ORDER, f'Invalid leg: {key}'
        return getattr(self, key)

    def __setitem__(self, key, value):
        assert key in LEG_ORDER, f'Invalid leg: {key}'
        setattr(self, key, value)

    def __iter__(self):
        return iter(self.to_list())

    def _binop(self, other, op):
        if isinstance(other, LegsAttr):
            return LegsAttr(*[op(a, b) for a, b in zip(self.to_list(), other.to_list())])
        return LegsAttr(*[op(a, other) for a in self.to_list()])

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    def __matmul__(self, other):
        return self._binop(other, lambda a, b: a @ b)

    def __repr__(self):
        return f'LegsAttr(FL={self.FL}, FR={self.FR}, RL={self.RL}, RR={self.RR})'
