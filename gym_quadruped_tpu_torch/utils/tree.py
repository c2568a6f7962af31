"""Walking nested states: the tensors of dataclasses, tuples, lists and dicts,
each with its key path in the form of `jax.tree_util.keystr` (`.qpos`,
`.sensors[0].points`, `[2].qvel`, `['qpos']`), so that a state of the port
and the reference's state pytree name their leaves alike."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch


def map_with_path(fn, tree, path: str = ''):
    """`tree` with every tensor x replaced by fn(path, x); dataclasses,
    tuples, lists and dicts are rebuilt around the results, other leaves
    (None, numbers, strings) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name), f'{path}.{f.name}')
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, x, f'{path}[{i}]') for i, x in enumerate(tree))
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, f'{path}[{k!r}]') for k, v in tree.items()}
    return tree


def leaves_with_path(tree) -> list:
    """[(key path, tensor)] of every tensor in `tree`, in walking order."""
    out = []
    map_with_path(lambda path, x: out.append((path, x)), tree)
    return out
