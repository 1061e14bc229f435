"""Batched tensor layouts: packed and padded.

Port of ``kaolin_tpu/ops/batch.py``.  Two layouts for ragged collections:

* **packed**: every sub-tensor flattened to ``(numel_i / last_dim,
  last_dim)`` and concatenated along the first axis; the ragged structure
  is carried by ``shape_per_tensor`` / ``first_idx``;
* **padded**: sub-tensors stacked into one dense tensor, padded up to
  ``max_shape`` with ``padding_value``.

The shape bookkeeping (``shape_per_tensor``, ``first_idx``,
``numel_per_tensor``) is host numpy int64, as in the JAX package; the
tensors stay on their device.
"""

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    'get_shape_per_tensor',
    'list_to_packed',
    'get_first_idx',
    'tile_to_packed',
    'packed_to_list',
    'fill_max_shape',
    'list_to_padded',
    'padded_to_list',
    'packed_to_padded',
    'padded_to_packed',
]


def _check_same_ndim(tensor_list):
    ndim = tensor_list[0].ndim
    for i, t in enumerate(tensor_list):
        if t.ndim != ndim:
            raise ValueError(
                f"Expected all tensors to have {ndim} dimensions "
                f"but got {t.ndim} at index {i}")


def get_shape_per_tensor(tensor_list) -> np.ndarray:
    """The shapes (but the last dim) of each tensor of the list.

    Returns:
        numpy int64 array of shape ``(B, ndim - 1)``.
    """
    _check_same_ndim(tensor_list)
    return np.array([tuple(t.shape[:-1]) for t in tensor_list],
                    dtype=np.int64)


def list_to_packed(tensor_list) -> Tuple[torch.Tensor, np.ndarray]:
    """Concatenate a list of tensors into the packed layout.

    Returns:
        (packed_tensor ``(sum_i numel_i / last_dim, last_dim)``,
        shape_per_tensor, host numpy ``(B, ndim - 1)``).
    """
    if len(tensor_list) == 0:
        raise ValueError("tensor_list is empty")
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    last_dim = tensor_list[0].shape[-1]
    for i, t in enumerate(tensor_list):
        if t.shape[-1] != last_dim:
            raise ValueError(
                f"Expected last dimension {last_dim} but got {t.shape[-1]} "
                f"at index {i}")
    packed = torch.cat([t.reshape(-1, last_dim) for t in tensor_list], dim=0)
    return packed, shape_per_tensor


def get_first_idx(numel_per_tensor) -> np.ndarray:
    """First-row offsets of each sub-tensor in the packed layout.

    Returns:
        numpy int64 ``(B + 1,)``, from 0 to the total number of rows.
    """
    numel_per_tensor = np.asarray(numel_per_tensor, dtype=np.int64)
    out = np.zeros(numel_per_tensor.shape[0] + 1, dtype=np.int64)
    np.cumsum(numel_per_tensor, out=out[1:])
    return out


def total_numel(shape_per_tensor) -> np.ndarray:
    """Rows per sub-tensor: the product over the ragged dims."""
    shape_per_tensor = np.asarray(shape_per_tensor, dtype=np.int64)
    return np.prod(shape_per_tensor, axis=1)


def tile_to_packed(values, numel_per_tensor) -> torch.Tensor:
    """Tile each per-tensor scalar over its packed rows: ``(total_rows, 1)``;
    differentiable (the backward is the per-segment sum)."""
    numel_per_tensor = np.asarray(numel_per_tensor, dtype=np.int64)
    values = torch.as_tensor(values)
    reps = torch.as_tensor(numel_per_tensor, device=values.device)
    return torch.repeat_interleave(values, reps,
                                   output_size=int(numel_per_tensor.sum())
                                   )[:, None]


def packed_to_list(packed_tensor, shape_per_tensor,
                   first_idx) -> List[torch.Tensor]:
    """Split a packed tensor back into a list of tensors."""
    shape_per_tensor = np.asarray(shape_per_tensor)
    first_idx = np.asarray(first_idx)
    last_dim = packed_tensor.shape[-1]
    out = []
    for i in range(shape_per_tensor.shape[0]):
        lo, hi = int(first_idx[i]), int(first_idx[i + 1])
        shape = tuple(int(s) for s in shape_per_tensor[i]) + (last_dim,)
        out.append(packed_tensor[lo:hi].reshape(shape))
    return out


def fill_max_shape(shape_per_tensor, partial_max_shape=None) -> np.ndarray:
    """Resolve a partial max_shape (-1 = infer) against shape_per_tensor."""
    shape_per_tensor = np.asarray(shape_per_tensor, dtype=np.int64)
    max_shape = shape_per_tensor.max(axis=0)
    if partial_max_shape is None:
        return max_shape
    partial = np.asarray(partial_max_shape, dtype=np.int64)
    if partial.shape[0] != shape_per_tensor.shape[1]:
        raise ValueError(
            f"partial_max_shape has {partial.shape[0]} dims but "
            f"shape_per_tensor has {shape_per_tensor.shape[1]}")
    out = np.where(partial == -1, max_shape, partial)
    if (out < max_shape).any():
        raise ValueError(
            f"max_shape {out.tolist()} is too small for tensors of max shape "
            f"{max_shape.tolist()}")
    return out


def list_to_padded(tensor_list, padding_value,
                   max_shape=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Stack a ragged list into a dense padded batch.

    Returns:
        (padded ``(B, *max_shape, last_dim)``, shape_per_tensor).
    """
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    max_shape = fill_max_shape(shape_per_tensor, max_shape)
    padded = []
    for t in tensor_list:
        pads = [0, 0]                           # F.pad: the last dim first
        for m, s in reversed(list(zip(max_shape, t.shape[:-1]))):
            pads += [0, int(m) - s]
        padded.append(F.pad(t, pads, value=padding_value))
    return torch.stack(padded, dim=0), shape_per_tensor


def padded_to_list(padded_tensor, shape_per_tensor) -> List[torch.Tensor]:
    """Slice a padded batch back into a ragged list."""
    shape_per_tensor = np.asarray(shape_per_tensor)
    out = []
    for i in range(shape_per_tensor.shape[0]):
        idx = (i,) + tuple(slice(0, int(s)) for s in shape_per_tensor[i])
        out.append(padded_tensor[idx])
    return out


def packed_to_padded(packed_tensor, shape_per_tensor, first_idx,
                     padding_value, max_shape=None) -> torch.Tensor:
    """Convert the packed layout to the padded layout."""
    tensors = packed_to_list(packed_tensor, shape_per_tensor, first_idx)
    padded, _ = list_to_padded(tensors, padding_value, max_shape)
    return padded


def padded_to_packed(padded_tensor, shape_per_tensor) -> torch.Tensor:
    """Convert the padded layout to the packed layout."""
    tensors = padded_to_list(padded_tensor, shape_per_tensor)
    packed, _ = list_to_packed(tensors)
    return packed
