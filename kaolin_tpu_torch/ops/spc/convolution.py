"""Sparse convolutions over an SPC octree (Conv3d / ConvTranspose3d).

Port of ``kaolin_tpu/ops/spc/convolution.py``.  Neighbours come from
:func:`~kaolin_tpu_torch.ops.spc.unbatched_query`, with the JAX package's
rule: for an output point ``P_o`` and tap k, ``conv3d`` reads the input
voxel at ``s * P_o + Kvec_k`` (``s = 2^jump``); the transpose reads, for an
output point ``V``, the voxel at ``U / s`` where ``U = V - Kvec_k``, kept iff
``U % s == 0``.  The JAX package queries in int16; here in int32.

The JAX package keeps the (K, N_out) neighbour table dense and sums a masked
(K, N_out, C_in) gather with one einsum.  Here the table is compacted to its
live (tap, output) pairs in tap order (one host read of the per-tap counts
per octree): one gather of their input rows, then per tap one matmul and
one ``index_add_`` into the output.  No row is gathered for a miss, so the
backward's scatter never piles the misses onto one input row.  Taps and
channels are summed in another order than the einsum's.
"""

import math

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.spc.spc import (unbatched_get_level_points,
                                          unbatched_query)

__all__ = ['conv3d', 'conv_transpose3d', 'Conv3d', 'ConvTranspose3d',
           'from_jax_params']


def _per_octree_slices(pyramids, lengths):
    """Byte, point and exsum offsets of each octree (host lists)."""
    lengths = [int(n) for n in lengths]
    points = [int(n) for n in pyramids[:, 1, -1]]
    return tuple(np.concatenate([[0], np.cumsum(n)]).tolist() for n in (
        lengths, points, [n + 1 for n in lengths]))


def tap_coords(out_pts, kernel_vectors, jump, transpose):
    """The input-level coords each (tap, output point) reads: (K * N_out,
    3) int32, and for the transpose the (K, N_out) mask of ``U % s == 0``
    (None for ``conv3d``).  ``kernel_vectors``: (K, 3) int32 on the points'
    device."""
    s = 1 << jump
    pts = out_pts.to(torch.int32)[None]
    kv = kernel_vectors[:, None]
    if not transpose:
        return (pts * s + kv).reshape(-1, 3), None
    u = pts - kv
    return (u // s).reshape(-1, 3), (u % s == 0).all(-1)


def tap_pairs(octree, exsum, out_pts, kernel_vectors, jump, level, offset,
              transpose):
    """The live (tap, output point) pairs of one octree, in tap order.

    Args:
        octree, exsum: one octree's bytes and exsum.
        out_pts: (N_out, 3) integer coords of the output level.
        kernel_vectors: (K, 3) int32 offsets, on the octree's device.
        jump, level: as in :func:`conv3d`; ``level`` is the input's.
        offset: the pyramid offset of the input level.
        transpose: the neighbour rule of :func:`conv_transpose3d`.

    Returns:
        (input rows, output rows, per-tap pair counts as a host list).
    """
    coords, live = tap_coords(out_pts, kernel_vectors, jump, transpose)
    K = kernel_vectors.shape[0]
    nidx = unbatched_query(octree, exsum, coords, level).reshape(K, -1)
    valid = nidx >= 0
    if live is not None:
        valid &= live
    tap, out_rows = torch.nonzero(valid, as_tuple=True)
    counts = torch.bincount(tap, minlength=K).tolist()
    return nidx[tap, out_rows].long() - offset, out_rows, counts


def tap_products(x, weight, in_rows, out_rows, counts, n_out):
    """``Y[o] = sum_k X[n(o, k)] W_k`` over the live pairs: one gather of
    the input rows, then per tap a matmul and an ``index_add_``."""
    gathered = x[in_rows]
    out = x.new_zeros((n_out, weight.shape[2]))
    start = 0
    for k, c in enumerate(counts):
        if c:
            out.index_add_(0, out_rows[start:start + c],
                           gathered[start:start + c] @ weight[k])
        start += c
    return out


def _conv(octrees, point_hierarchies, level, out_level, pyramids, exsum,
          input, weight, kernel_vectors, jump, bias, lengths, transpose):
    pyr = torch.as_tensor(pyramids).cpu()
    if lengths is None:     # bytes per octree = points above the deepest
        lengths = pyr[:, 1, -2]
    byte_starts, point_starts, exsum_starts = _per_octree_slices(
        pyr, torch.as_tensor(lengths).reshape(-1).tolist())
    kv = torch.as_tensor(np.asarray(kernel_vectors), dtype=torch.int32,
                         device=input.device)
    outs = []
    in_start = 0
    for b in range(pyr.shape[0]):
        n_in = int(pyr[b, 0, level])
        x = input[in_start:in_start + n_in]
        in_start += n_in
        ph_b = point_hierarchies[point_starts[b]:point_starts[b + 1]]
        out_pts = unbatched_get_level_points(ph_b, pyr[b], out_level)
        pairs = tap_pairs(octrees[byte_starts[b]:byte_starts[b + 1]],
                          exsum[exsum_starts[b]:exsum_starts[b + 1]],
                          out_pts, kv, jump, level, int(pyr[b, 1, level]),
                          transpose)
        outs.append(tap_products(x, weight, *pairs, out_pts.shape[0]))
    out = torch.cat(outs)
    if bias is not None:
        out = out + bias[None]
    return out, int(out_level)


def conv3d(octrees, point_hierarchies, level, pyramids, exsum, input,
           weight, kernel_vectors, jump=0, bias=None, **kwargs):
    """Sparse convolution over an SPC: ``Y_o = sum_k W_k X_{n(o,k)} (+ b)``.

    Args:
        octrees / point_hierarchies / pyramids / exsum: the SPC's scan
            products (``pyramids`` host values).
        level: level of the ``input`` features.
        input: packed (points at ``level`` over the batch, in_ch) features.
        weight: (K, in_ch, out_ch).
        kernel_vectors: (K, 3) int offsets.
        jump: downsampling level delta (output level = level - jump).
        bias: optional (out_ch,).
        lengths: optional keyword, (B,) bytes per octree (default: the
            pyramids' point count above the deepest level).

    Returns:
        (output packed (points at the output level, out_ch), output level).
    """
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
        return (out if bias is None else out + bias[None]), int(level)
    return _conv(octrees, point_hierarchies, level, level - jump, pyramids,
                 exsum, input, weight, kernel_vectors, jump, bias,
                 kwargs.get('lengths'), transpose=False)


def conv_transpose3d(octrees, point_hierarchies, level, pyramids, exsum,
                     input, weight, kernel_vectors, jump=0, bias=None,
                     **kwargs):
    """Transposed sparse convolution (upsampling, output level = level +
    jump); arguments as in :func:`conv3d`.  For output point V and tap k,
    ``U = V - Kvec_k`` contributes iff ``U % s == 0``, from the input voxel
    at ``U / s``."""
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
        return (out if bias is None else out + bias[None]), int(level)
    return _conv(octrees, point_hierarchies, level, level + jump, pyramids,
                 exsum, input, weight, kernel_vectors, jump, bias,
                 kwargs.get('lengths'), transpose=True)


class _SpcConv(nn.Module):
    """The weights and bias of an SPC convolution.

    The weight, (K, in_channels, out_channels), starts from
    ``N(0, 1) * sqrt(2 / (in_channels * K))`` drawn on the CPU from
    ``generator`` (torch's default generator when None), the bias from 0,
    as the JAX modules' initialisers do; both then move to ``device``
    (default: the card).
    """
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_vectors, jump=0,
                 use_bias=True, generator=None, device=None):
        super().__init__()
        device = entry_device(device)
        self.kernel_vectors = np.asarray(kernel_vectors, dtype=np.int32)
        self.jump = int(jump)
        kdim = self.kernel_vectors.shape[0]
        scale = math.sqrt(2.0 / (in_channels * kdim))
        weight = torch.randn((kdim, in_channels, out_channels),
                             generator=generator) * scale
        self.weight = nn.Parameter(weight.to(device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if use_bias else None)

    def forward(self, octrees, point_hierarchies, level, pyramids, exsum,
                input, **kwargs):
        """(output features, output level); see :func:`conv3d`."""
        return self._fn(octrees, point_hierarchies, level, pyramids, exsum,
                        input, self.weight, self.kernel_vectors, self.jump,
                        self.bias, **kwargs)


class Conv3d(_SpcConv):
    """:func:`conv3d` with its weights (see :class:`_SpcConv`)."""
    _fn = staticmethod(conv3d)


class ConvTranspose3d(_SpcConv):
    """:func:`conv_transpose3d` with its weights (see :class:`_SpcConv`)."""
    _fn = staticmethod(conv_transpose3d)


def from_jax_params(params, device=None):
    """The state dict of a :class:`Conv3d` / :class:`ConvTranspose3d` from
    the JAX module's flax params (numpy arrays: ``weight`` (K, Cin, Cout),
    optional ``bias`` (Cout,); a dict with a ``'params'`` key is unwrapped),
    on ``device`` (default: the card); load it with ``load_state_dict``."""
    device = entry_device(device)
    params = params.get('params', params)
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in params.items()}
