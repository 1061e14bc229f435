"""Parameter / optimizer-state checkpointing.

Port of ``kaolin_tpu/utils/checkpoint.py``.  Training state is nested
dicts, lists, tuples and NamedTuples of tensors and Python scalars, such as
``{'params': InverseRenderParams(...), 'opt': optimizer.state_dict()}``.

* :func:`save` / :func:`load`: one ``torch.save`` file per step under
  ``directory/step_{step:010d}/`` (where the JAX package uses orbax).
* :func:`save_npz` / :func:`load_npz`: a single ``.npz`` file.

Both store the leaves, flattened in JAX's leaf order for the same
structure (dict keys sorted, NamedTuple fields in order, None holds no
leaf), beside a plain JSON description of the structure.  No class is
pickled, so ``torch.load(weights_only=True)`` reads the files; a
NamedTuple is restored from ``like`` (:func:`load`) or by importing its
class by name (:func:`load_npz`).
"""

import importlib
import itertools
import json
import os
import shutil

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['save', 'load', 'save_npz', 'load_npz', 'latest_step']

_STATE_FILE = 'state.pt'
_SCALARS = {'bool': bool, 'int': int, 'float': float, 'str': str}


def _step_dir(directory, step):
    return os.path.join(directory, f'step_{step:010d}')


def _flatten(tree, leaves):
    """The structure of ``tree`` as JSON-able nodes; its leaves are
    appended to ``leaves`` in JAX's order."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return ['tensor']
    if tree is None:
        return ['none']
    for name, kind in _SCALARS.items():     # bool before int
        if isinstance(tree, kind):
            leaves.append(tree)
            return ['scalar', name]
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ['dict', [[k, _flatten(tree[k], leaves)] for k in keys]]
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        cls = type(tree)
        return ['namedtuple', cls.__module__, cls.__qualname__,
                list(tree._fields), [_flatten(x, leaves) for x in tree]]
    if isinstance(tree, (list, tuple)):
        return [type(tree).__name__, [_flatten(x, leaves) for x in tree]]
    raise TypeError(f'cannot checkpoint a leaf of type {type(tree)}: the '
                    f'state holds tensors, Python scalars and None in '
                    f'dicts, lists, tuples and NamedTuples')


def _structure(tree):
    leaves = []
    nodes = _flatten(tree, leaves)
    return json.loads(json.dumps(nodes)), leaves


def _namedtuple_class(module, qualname, fields):
    cls = importlib.import_module(module)
    for part in qualname.split('.'):
        cls = getattr(cls, part, None)
    if not (isinstance(cls, type) and issubclass(cls, tuple)
            and list(getattr(cls, '_fields', ())) == fields):
        raise ValueError(f'cannot restore the NamedTuple {module}.{qualname}'
                         f'{tuple(fields)}: no such class')
    return cls


def _unflatten(node, leaf, like=None):
    """The tree of ``node``, each leaf from ``leaf(node)`` in order;
    NamedTuple classes from ``like`` when given."""
    kind = node[0]
    if kind in ('tensor', 'scalar'):
        return leaf(node)
    if kind == 'none':
        return None
    if kind == 'dict':
        out = {k: _unflatten(n, leaf, None if like is None else like[k])
               for k, n in node[1]}
        return out if like is None else {k: out[k] for k in like}
    children = node[-1]
    sub = [None] * len(children) if like is None else list(like)
    items = [_unflatten(n, leaf, s) for n, s in zip(children, sub)]
    if kind == 'namedtuple':
        cls = (type(like) if like is not None
               else _namedtuple_class(node[1], node[2], node[3]))
        return cls(*items)
    return tuple(items) if kind == 'tuple' else items


def save(directory, pytree, step=0, overwrite=True):
    """Save a training-state checkpoint.

    Args:
        directory: checkpoint root (created if missing).
        pytree: the state: tensors (any device) and Python scalars in
            nested dicts, lists, tuples and NamedTuples.
        step: training step used to name the checkpoint.
        overwrite: replace an existing checkpoint at this step (else
            raise ``FileExistsError``).

    Returns:
        the checkpoint's directory.
    """
    nodes, leaves = _structure(pytree)
    path = os.path.abspath(_step_dir(directory, step))
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f'checkpoint {path!r} exists')
        shutil.rmtree(path)
    os.makedirs(path)
    tmp = os.path.join(path, _STATE_FILE + '.tmp')
    torch.save({'structure': json.dumps(nodes),
                'leaves': [x.detach().cpu() if torch.is_tensor(x) else x
                           for x in leaves]}, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    return path


def load(directory, like, step=None):
    """Restore a checkpoint saved by :func:`save`.

    Args:
        directory: checkpoint root.
        like: a state of the same structure (e.g. the freshly initialised
            one): each restored tensor goes to the device and dtype of its
            counterpart in ``like``.
        step: step to restore; default: the latest.

    Raises:
        FileNotFoundError: no checkpoint.
        ValueError: the checkpoint's structure is not ``like``'s.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {directory!r}')
    path = os.path.join(os.path.abspath(_step_dir(directory, step)),
                        _STATE_FILE)
    data = torch.load(path, map_location='cpu', weights_only=True)
    nodes, like_leaves = _structure(like)
    if json.loads(data['structure']) != nodes:
        raise ValueError(f'the checkpoint {path!r} does not have the '
                         f'structure of `like`')
    leaves = iter([x.to(device=y.device, dtype=y.dtype)
                   if torch.is_tensor(y) else x
                   for x, y in zip(data['leaves'], like_leaves)])
    return _unflatten(nodes, lambda _: next(leaves), like)


def latest_step(directory):
    """Largest step with a checkpoint under ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith('step_'):
            try:
                steps.append(int(name[len('step_'):]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_npz(path, pytree):
    """Single-file .npz checkpoint: the leaves as ``leaf_{i}`` in JAX's
    leaf order, the structure as JSON text in ``__structure__``."""
    nodes, leaves = _structure(pytree)
    arrays = {f'leaf_{i}': (x.detach().cpu().numpy() if torch.is_tensor(x)
                            else np.asarray(x))
              for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __structure__=np.frombuffer(
        json.dumps(nodes).encode(), dtype=np.uint8), **arrays)
    return path


def load_npz(path, device=None):
    """Restore a state saved by :func:`save_npz`, its tensors on
    ``device`` (default: the card, see
    :func:`~kaolin_tpu_torch._device.entry_device`)."""
    device = entry_device(device)
    index = itertools.count()
    with np.load(path, allow_pickle=False) as data:

        def leaf(node):
            arr = data[f'leaf_{next(index)}']
            if node[0] == 'tensor':
                return torch.as_tensor(arr, device=device)
            return _SCALARS[node[1]](arr.item())

        return _unflatten(json.loads(data['__structure__'].tobytes()), leaf)
