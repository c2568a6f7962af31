"""Checkpoints of a batched state: save and restore every tensor as .npz.

Counterpart of gym_quadruped_tpu/utils/checkpoint.py. Each tensor is stored
under its key path in the reference's form (`.qpos`, `.sensors[0].points`,
`[2].qvel` in a mixed batch's state tuple; `utils/tree.py`), so a checkpoint
that the reference wrote restores into the port: the keys the port's state
lacks, the reference's PRNG keys (the state's `.rng`, the IMU state's), are
not read. The port draws from a `torch.Generator` rather than keys inside
the state, so an exact resume also needs the generator's state: pass the
generator to `save` and `restore`, and it goes under a key of its own.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gym_quadruped_tpu_torch.utils.tree import leaves_with_path, map_with_path

# the generator's state; a key path starts with '.' or '[', so none clashes
GENERATOR_KEY = 'torch.Generator'


def save(path, state, generator: torch.Generator | None = None) -> None:
    """Write every tensor of `state` (an EnvState, a tuple of them, any
    nesting of dataclasses, tuples, lists and dicts) to `path` (.npz), and
    the generator's state when one is given."""
    arrays = {key: x.detach().cpu().numpy() for key, x in leaves_with_path(state)}
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def restore(path, like, generator: torch.Generator | None = None):
    """The state saved at `path`, in the structure of `like`, each tensor on
    `like`'s tensor's device in its dtype; with `generator`, its state is
    set from the checkpoint's. Raises KeyError on a missing leaf or a shape
    other than `like`'s."""
    with np.load(path) as data:
        def load(key, ref):
            if key not in data:
                raise KeyError(f'checkpoint {path} missing leaf {key}')
            arr = data[key]
            if arr.shape != tuple(ref.shape):
                raise KeyError(f'checkpoint leaf {key} shape {arr.shape} != {tuple(ref.shape)}')
            return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)

        state = map_with_path(load, like)
        if generator is not None:
            if GENERATOR_KEY not in data:
                raise KeyError(f'checkpoint {path} holds no generator state')
            generator.set_state(torch.from_numpy(data[GENERATOR_KEY]))
    return state
