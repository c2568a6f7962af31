"""HDF5 trajectory store, in the schema of gym_quadruped_tpu/utils/data/h5.py.

A `recordings` group holds one resizable float64 dataset per observable,
shaped (episode, time, *obs_shape), a `time` dataset (episode, time, 1) and
an `action` dataset; an `env_hparams` group holds the env's constructor
arguments (lists and tuples JSON-encoded in attributes, classes as
'TYPE:module.Class' strings), from which the env can be built again. Every
dataset and attribute is the reference's, so either package reads the
other's files. `h5py` is imported when a file is opened.

Class references: this package's classes are written under the reference
package's module path (the sensors' modules have the same names in both), so
a file is the same whichever package wrote it. Read back, a reference into
either package resolves into this one; a reference to any other module is
refused, so reading a file imports nothing outside this package.

`append_batch` writes a (B, T, ...) rollout as B episodes with one resize
per dataset: the same file as B calls of `append_trajectory`, each of which
opens the file once.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import torch

_PACKAGE = 'gym_quadruped_tpu_torch'
_REFERENCE = 'gym_quadruped_tpu'


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError('h5py is needed to write or read HDF5 trajectory files') from e
    return h5py


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _class_ref(cls) -> str:
    module = cls.__module__
    if module == _PACKAGE or module.startswith(_PACKAGE + '.'):
        module = _REFERENCE + module[len(_PACKAGE):]
    return f'TYPE:{module}.{cls.__name__}'


def _import_class(ref: str):
    module, name = ref.split(':', 1)[1].rsplit('.', 1)
    root, _, rest = module.partition('.')
    if root not in (_PACKAGE, _REFERENCE):
        raise ValueError(f'class reference {ref!r} is outside {_PACKAGE}: not imported')
    return getattr(importlib.import_module(f'{_PACKAGE}.{rest}' if rest else _PACKAGE), name)


def save_dict_to_h5(h5group, data: dict):
    """Save a nested dict into an HDF5 group (the reference's contract):
    dicts become subgroups, lists and tuples JSON attributes (classes as
    'TYPE:' references), scalars, strings and arrays attributes; None is
    skipped."""
    for key, value in data.items():
        if isinstance(value, dict):
            save_dict_to_h5(h5group.require_group(key), value)
        elif isinstance(value, (list, tuple)):
            try:
                h5group.attrs[key] = json.dumps(value)
            except TypeError:
                if not isinstance(value[0], type):
                    raise NotImplementedError(f'Cannot store {type(value[0])} objects')
                h5group.attrs[key] = json.dumps([_class_ref(v) for v in value])
        elif isinstance(value, (str, int, float, bool, np.ndarray, np.number)):
            h5group.attrs[key] = value
        elif value is not None:
            raise TypeError(f"Cannot save type {type(value)} for key '{key}'")


def load_dict_from_h5(h5group) -> dict:
    """Load a nested dict saved by `save_dict_to_h5`, 'TYPE:' references
    resolved into this package."""
    h5py = _h5py()
    data = {}
    for key, value in h5group.attrs.items():
        try:
            decoded = json.loads(value)
        except (json.JSONDecodeError, TypeError):
            data[key] = value
            continue
        if isinstance(decoded, list):
            decoded = [_import_class(e) if isinstance(e, str) and e.startswith('TYPE:') else e
                       for e in decoded]
        data[key] = decoded
    for key, sub in h5group.items():
        if isinstance(sub, h5py.Group):
            data[key] = load_dict_from_h5(sub)
    return data


class H5Writer:
    """Trajectory writer (the reference's H5Writer).

    Args:
        file_path: the .h5 file, created anew.
        env: a QuadrupedEnv (a group of a MixedQuadrupedEnv too): its
            observation_space_dims(), model.m.nu and get_hyperparameters().
        obs_dims, action_dim, env_hparams: given without an env, or to
            override its.
        extra_obs: {name: obs_shape} additional datasets.
    """

    def __init__(self, file_path, env=None, obs_dims: dict | None = None,
                 action_dim: int | None = None, env_hparams: dict | None = None,
                 extra_obs: dict | None = None):
        h5py = _h5py()
        if env is not None:
            obs_dims = obs_dims or env.observation_space_dims()
            action_dim = action_dim if action_dim is not None else env.model.m.nu
            env_hparams = env_hparams or env.get_hyperparameters()
        self.file_path = Path(file_path)
        self.file_path.parent.mkdir(parents=True, exist_ok=True)

        def dataset(rec, key, shape):
            rec.create_dataset(key, shape=(0, 0) + shape, maxshape=(None, None) + shape,
                               dtype='float64')

        with h5py.File(self.file_path, 'w') as hf:
            save_dict_to_h5(hf.create_group('env_hparams'), env_hparams or {})
            rec = hf.create_group('recordings')
            dataset(rec, 'time', (1,))
            for key, dim in (obs_dims or {}).items():
                dataset(rec, key, (dim,) if np.isscalar(dim) else tuple(dim))
            if action_dim:
                dataset(rec, 'action', (action_dim,))
            for key, shape in (extra_obs or {}).items():
                dataset(rec, key, tuple(shape))

    def append_trajectory(self, state_obs_traj: dict, time):
        """Append one episode: each value (T, *obs_shape), time (T,) or (T, 1)."""
        self.append_batch({k: _numpy(v)[None] for k, v in state_obs_traj.items()},
                          _numpy(time).reshape(1, -1))

    def append_batch(self, batch_obs_traj: dict, time):
        """Append a batched rollout as B episodes: each value (B, T,
        *obs_shape) (tensors on any device, or arrays), time (B, T) or (T,)
        shared across the batch."""
        values = {k: _numpy(v) for k, v in batch_obs_traj.items()}
        B, T = next(iter(values.values())).shape[:2]
        time = _numpy(time)
        time = np.broadcast_to(time.reshape(-1), (B, T)) if time.ndim == 1 else time
        if time.shape[:2] != (B, T):
            raise ValueError(f'time of shape {time.shape} for a batch of ({B}, {T})')
        for key, value in values.items():
            if value.shape[:2] != (B, T):
                raise ValueError(f'Observation {key} has inconsistent time steps: '
                                 f'{value.shape[:2]} vs {(B, T)}')
        with _h5py().File(self.file_path, 'a') as hf:
            rec = hf['recordings']
            e = rec['time'].shape[0]
            rec['time'].resize((e + B, T, 1))
            rec['time'][e:] = time.reshape(B, T, 1)
            for key, value in values.items():
                ds = rec[key]
                ds.resize((e + B, T) + value.shape[2:])
                ds[e:] = value


class H5Reader:
    """Trajectory reader (the reference's H5Reader)."""

    def __init__(self, file_path):
        h5py = _h5py()
        self.file_path = Path(file_path)
        if not self.file_path.exists():
            raise FileNotFoundError(f'File not found: {self.file_path}')
        self.h5py_file = h5py.File(self.file_path, 'r')
        self.recordings = self.h5py_file['recordings']
        self.env_hparams = load_dict_from_h5(self.h5py_file['env_hparams'])
        self.n_trajectories = self.recordings['time'].shape[0]

    def len(self):
        return self.n_trajectories

    def get_trajectory(self, traj_idx):
        """(time (T, 1), {name: (T, ...)}) of episode traj_idx."""
        time = self.recordings['time'][traj_idx]
        traj_data = {key: self.recordings[key][traj_idx]
                     for key in self.recordings if key != 'time'}
        return time, traj_data

    def close(self):
        self.h5py_file.close()
