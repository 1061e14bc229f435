"""Bilinear texture sampling and its backward (CUDA kernels E1 and E2).

Port of ``kaolin_tpu/render/mesh/utils.py::_flat_corner_idx`` and the
forward and backward of ``_bilinear_sample``, which the JAX package writes
by hand (its texture gradient ``_tex_grad_mxu`` as one-hot matrix products
for the TPU's matrix unit).  The port computes the same functions with
kernels written for the card (``csrc/epilogue.cu``):

* E1, ``bilinear_forward_kernel``: per pixel the four corner taps, each
  corner clipped on its own, and the lerp in the JAX package's order;
* E2, the backward: ``bilinear_pixels_kernel`` writes dx, dy and the four
  taps' texel ids; the extension module sorts the (tap, pixel) entries by
  texel with PyTorch's stable sort; ``segment_pieces_kernel`` and
  ``segment_combine_kernel`` add each texel's ``w_tap * g`` terms in that
  order, with no atomics, so every run gives the same bits.

Beside each kernel is its plain PyTorch version
(:func:`_bilinear_forward_torch`, :func:`_bilinear_backward_torch`).  The
wrappers :func:`_bilinear_forward` and :func:`_bilinear_backward` run the
plain version for tensors on the CPU and the kernel for tensors on a CUDA
device; there is no fallback between the two.  A kernel is launched
through the extension module ``csrc/epilogue_module.cpp``.  ``LAUNCHES``
counts launches: a wrapper adds one where it launches, and a replayed CUDA
graph adds what it holds (``models/inverse_render.py::compiled_step``).
"""

import torch

from kaolin_tpu_torch.render.mesh._fused import _check

__all__ = ['LAUNCHES']

LAUNCHES = {'sample': 0, 'sample_bwd': 0}


def _flat_corner_idx(x, y, H, W, B, P):
    """Clipped corner indices + lerp weights for bilinear sampling.

    x, y: (B*P,) continuous pixel coords.  Returns flat int32 row ids into
    the (B*H*W, C) channels-last texture table, taps (00, 01, 10, 11),
    plus (wx, wy).
    """
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    x0i = torch.clamp(xi, 0, W - 1)
    x1i = torch.clamp(xi + 1, 0, W - 1)
    y0i = torch.clamp(yi, 0, H - 1)
    y1i = torch.clamp(yi + 1, 0, H - 1)
    boff = torch.arange(B, dtype=torch.int32,
                        device=x.device).repeat_interleave(P) * (H * W)
    i00 = boff + y0i * W + x0i
    i01 = boff + y0i * W + x1i
    i10 = boff + y1i * W + x0i
    i11 = boff + y1i * W + x1i
    return (i00, i01, i10, i11), wx, wy


def _taps(tex_rows, x, y, hw):
    """(the four tap rows (B*P, C) each, wx (B*P, 1), wy (B*P, 1), ids)."""
    H, W, B, P = hw
    ids, wx, wy = _flat_corner_idx(x, y, H, W, B, P)
    rows = [tex_rows.index_select(0, i) for i in ids]
    return rows, wx[:, None], wy[:, None], ids


def _bilinear_forward_torch(tex_rows, x, y, hw):
    """E1's plain version: ``(B*P, C)`` samples of the ``(B*H*W, C)`` table
    at pixel coords x, y (``hw`` = (H, W, B, P))."""
    (v00, v01, v10, v11), wx, wy, _ = _taps(tex_rows, x, y, hw)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _bilinear_backward_torch(tex_rows, x, y, g, hw):
    """E2's plain version: (dT (B*H*W, C), dx (B*P,), dy (B*P,)) for the
    output cotangent g (B*P, C).  dx and dy as the JAX package's backward
    (floor has zero derivative, so they flow through wx and wy only); dT
    the ``index_add_`` of ``g * w_tap`` for taps 00, 01, 10, 11 in turn."""
    (v00, v01, v10, v11), wx, wy, ids = _taps(tex_rows, x, y, hw)
    dx = torch.sum(g * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy), dim=-1)
    dy = torch.sum(g * ((v10 - v00) * (1 - wx) + (v11 - v01) * wx), dim=-1)
    dt = torch.zeros_like(tex_rows)
    weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    for i, w in zip(ids, weights):
        dt.index_add_(0, i, g * w)
    return dt, dx, dy


_ext = _stream = None       # the extension module, the stream getter


def _bind():
    global _ext, _stream
    if _ext is None:
        from kaolin_tpu_torch import _cuda
        _stream = _cuda.stream_getter()
        _ext = _cuda.load_module('epilogue')
    return _ext


def _refused(tex_rows, x, y, hw, g=None):
    """Raise for inputs the extension refused."""
    H, W, B, P = hw
    Q, C = B * P, tex_rows.shape[-1]
    if min(H, W, P) < 1 or x.dim() != 1 or x.shape[0] != Q:
        raise ValueError(f'bilinear sample: {tuple(x.shape)} pixel coords '
                         f'for hw = {hw}')
    _check('tex_rows', tex_rows, torch.float32, (B * H * W, C), x.device)
    for name, t in (('x', x), ('y', y)):
        _check(name, t, torch.float32, (Q,), x.device)
    if g is not None:
        _check('g', g, torch.float32, (Q, C), x.device)
    raise ValueError('bilinear sample kernels index with ints: 4 * B * P '
                     'and B * P * C must be below 2^31')


def _bilinear_forward_cuda(tex_rows, x, y, hw):
    """Launch E1; same contract as the plain version."""
    H, W, _, P = hw
    out = (_ext or _bind()).sample(tex_rows, x, y, H, W, P,
                                   _stream(x.get_device()))
    if out is None:
        _refused(tex_rows, x, y, hw)
    LAUNCHES['sample'] += 1
    return out


def _bilinear_backward_cuda(tex_rows, x, y, g, hw):
    """Launch E2; same contract as the plain version."""
    H, W, _, P = hw
    out = (_ext or _bind()).sample_backward(tex_rows, x, y, g, H, W, P,
                                            _stream(x.get_device()))
    if out is None:
        _refused(tex_rows, x, y, hw, g)
    LAUNCHES['sample_bwd'] += 1
    return out


def _bilinear_forward(tex_rows, x, y, hw):
    """Bilinear samples (B*P, C): CPU tensors run
    :func:`_bilinear_forward_torch`, CUDA tensors launch E1."""
    if x.device.type == 'cpu':
        return _bilinear_forward_torch(tex_rows, x, y, hw)
    if x.device.type != 'cuda':
        raise ValueError(f'no bilinear sample for device {x.device}')
    return _bilinear_forward_cuda(tex_rows, x, y, hw)


def _bilinear_backward(tex_rows, x, y, g, hw):
    """(dT, dx, dy): CPU tensors run :func:`_bilinear_backward_torch`,
    CUDA tensors launch E2."""
    if x.device.type == 'cpu':
        return _bilinear_backward_torch(tex_rows, x, y, g, hw)
    if x.device.type != 'cuda':
        raise ValueError(f'no bilinear sample backward for device {x.device}')
    return _bilinear_backward_cuda(tex_rows, x, y, g, hw)
