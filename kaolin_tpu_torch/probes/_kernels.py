"""Probe kernels P1 (kA..kH) and P2 (the dummy grid): wrappers and plain
versions.

Ports of the Pallas TPU probes ``scripts/probe_r5_mosaic3.py::kA..kH`` and
``scripts/probe_r5_stages.py::dummy_kernel``; the CUDA kernels are in
``csrc/probes.cu``.  Layouts follow the scripts: ``x`` is (NB, R, C)
float32 (NB grid steps), ``nbs`` is (NB, 2) int32 of which column 0 is
read, ``ids`` is (NB, 1, CK) int32 rows of ``table`` (M, R, C) float32.

CPU tensors run the plain PyTorch versions (``PLAIN``); CUDA tensors
launch the kernel or raise.  ``LAUNCHES`` counts launches by
wrapper name (a call captured in a CUDA graph counts once, its replays
not at all).  Every kernel equals its plain version bit for bit: the sums
run in the scripts' order.
"""

import torch

__all__ = ['kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH', 'dummy',
           'LAUNCHES', 'PLAIN', 'KB_SLOTS', 'P2_TILE_BYTES',
           'kb_smem_bytes']

LAUNCHES = {k: 0 for k in ('kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH',
                           'dummy')}

ROLL_LANES, SHIFT_LANES, ROLL_ROWS = 0, 1, 2     # probe_shift's ops
# kB's ring in csrc/probes.cu (KB_SLOTS row slots after KB_BARRIERS bytes of
# barriers) and P2's tile (P2_TILE_BYTES a CTA); a CPU test holds these in
# step with the source
KB_SLOTS = 8
KB_BARRIERS = 128
P2_TILE_BYTES = 4096


def kb_smem_bytes(row_floats):
    """Dynamic shared memory of one kB CTA: its barriers and KB_SLOTS row
    slots of ``row_floats`` float32."""
    return KB_BARRIERS + KB_SLOTS * 4 * row_floats
_SHIFTS = {'kE': (ROLL_LANES, 3), 'kF': (ROLL_LANES, 3),
           'kG': (SHIFT_LANES, 4), 'kH': (ROLL_ROWS, 1)}


# ---------------------------------------------------------------------------
# plain versions

def _kA_torch(nbs, x):
    """x added nbs[b, 0] times, from 0, in order."""
    nb = nbs[:, 0].reshape(-1, *([1] * (x.dim() - 1)))
    acc = torch.zeros_like(x)
    for j in range(int(nb.max()) if nb.numel() else 0):
        acc = torch.where(j < nb, acc + x, acc)
    return acc


def _row_sum_torch(ids, table, count=None):
    """sum over j < count[b] (default: all CK) of table[ids[b, 0, j]], in
    j order from 0."""
    ids = ids[:, 0].long()
    acc = table.new_zeros((ids.shape[0],) + tuple(table.shape[1:]))
    shape = (-1,) + (1,) * (table.dim() - 1)
    for j in range(ids.shape[1]):
        row = table[ids[:, j]]
        acc = acc + row if count is None else torch.where(
            (j < count).reshape(shape), acc + row, acc)
    return acc


def _shift_torch(x, op, s):
    if op == ROLL_LANES:
        return x + torch.roll(x, s, dims=-1)
    if op == SHIFT_LANES:
        return x + torch.cat([x[..., s:], torch.zeros_like(x[..., :s])],
                             dim=-1)
    return x + torch.roll(x, s, dims=-2)


def _dummy_torch(x):
    return x * 2.


PLAIN = {
    'kA': _kA_torch,
    'kB': lambda ids, table, x: _row_sum_torch(ids, table),
    # kC runs on kD's kernel with every count CK: kD's plain version so
    'kC': lambda ids, table, x: _row_sum_torch(
        ids, table, torch.full((ids.shape[0],), ids.shape[2],
                               dtype=torch.int32, device=ids.device)),
    'kD': lambda nbs, ids, table, x: _row_sum_torch(ids, table, nbs[:, 0]),
    'kE': lambda x: _shift_torch(x, *_SHIFTS['kE']),
    'kF': lambda x: _shift_torch(x, *_SHIFTS['kF']),
    'kG': lambda x: _shift_torch(x, *_SHIFTS['kG']),
    'kH': lambda x: _shift_torch(x, *_SHIFTS['kH']),
    'dummy': _dummy_torch,
}


# ---------------------------------------------------------------------------
# CUDA launches: each wrapper hands its tensors and the current stream to an
# entry point of the extension module (csrc/probes_module.cpp), which tests
# them, allocates the output and launches in C++, so a call costs the host
# about what one PyTorch op costs.  Inputs it refuses come back as None and
# are diagnosed here.

_F32, _I32 = torch.float32, torch.int32
_ext = _stream = None       # the extension module, the stream getter


def _bind():
    global _ext, _stream
    if _ext is None:
        from kaolin_tpu_torch import _cuda
        _stream = _cuda.stream_getter()
        _ext = _cuda.load_module('probes')
    return _ext


def _check(name, t, dtype, ndim, index):
    """Raise ValueError unless ``t`` is a contiguous, 16-byte aligned
    ``dtype`` tensor of ``ndim`` dims (any for None) on CUDA device
    ``index``: the extension's test of one input."""
    if (t.dtype is not dtype or t.get_device() != index
            or t.data_ptr() & 15 or (ndim is not None and t.dim() != ndim)
            or not t.is_contiguous()):
        raise ValueError(
            f'{name}: expected a contiguous, 16-byte aligned {dtype} tensor '
            f'of {ndim or "any number of"} dims on cuda:{index}, got '
            f'{t.dtype} {tuple(t.shape)} on {t.device}')


def _plain(name, x, *args):
    """The plain version, for a CPU tensor ``x``; other devices raise."""
    if x.device.type != 'cpu':
        raise ValueError(f'no probe kernel for device {x.device}')
    return PLAIN[name](*args)


def _reject(name, x, tensors, nbs=None):
    """Raise for inputs the extension refused: the first of ``tensors``
    ((label, tensor, dtype, ndim)) that fails its test (:func:`_check`), else
    ``nbs`` without a row per b (its column 0 is read), else the shapes
    (rows of x a multiple of 4 floats, the kernels move float4s; with ids
    and a table, ids (b, 1, CK) and table rows shaped like x[b])."""
    index = x.get_device()
    for label, t, dtype, ndim in tensors:
        _check(label, t, dtype, ndim, index)
    nb = x.shape[0] if x.dim() else None
    if nbs is not None and (nbs.shape[0] != nb or not nbs.shape[1]):
        raise ValueError(f'nbs: expected {nb} rows of at least one count, '
                         f'got {tuple(nbs.shape)}')
    rows = (f', ids be ({nb}, 1, CK) and table rows shaped like x[b]'
            if any(label == 'ids' for label, *_ in tensors) else '')
    raise ValueError(f'{name}: x[b] must hold a multiple of 4 floats{rows}, '
                     f'in fewer than 2^31 elements; got x {tuple(x.shape)}'
                     + ''.join(f', {label} {tuple(t.shape)}'
                               for label, t, *_ in tensors if label != 'x'))


def _row_sum(name, ids, table, x, nbs=None):
    """kB through the TMA ring (``row_sum``); kC (``nbs`` None: every count
    CK) and kD through kD's kernel (``bag_sum``)."""
    if not x.is_cuda:
        return (_plain(name, x, nbs, ids, table, x) if name == 'kD'
                else _plain(name, x, ids, table, x))
    ext = _ext or _bind()
    stream = _stream(x.get_device())
    out = (ext.row_sum(ids, table, x, stream) if name == 'kB'
           else ext.bag_sum(nbs, ids, table, x, stream))
    if out is None:
        _reject(name, x, (('ids', ids, _I32, 3), ('table', table, _F32, None))
                + (() if nbs is None else (('nbs', nbs, _I32, 2),)), nbs)
    LAUNCHES[name] += 1
    return out


def kA(nbs, x):
    """x[b] added nbs[b, 0] times, from 0 (a loop bound read at run
    time)."""
    if not x.is_cuda:
        return _plain('kA', x, nbs, x)
    out = (_ext or _bind()).dyn_loop(nbs, x, _stream(x.get_device()))
    if out is None:
        _reject('kA', x, (('x', x, _F32, None), ('nbs', nbs, _I32, 2)), nbs)
    LAUNCHES['kA'] += 1
    return out


def kB(ids, table, x):
    """sum over j < CK of table[ids[b, 0, j]]; rows staged in shared memory
    by the copy engine, KB_SLOTS in flight per bag."""
    return _row_sum('kB', ids, table, x)


def kC(ids, table, x):
    """The same sum, rows loaded straight into registers (kD's kernel with
    every count CK)."""
    return _row_sum('kC', ids, table, x)


def kD(nbs, ids, table, x):
    """sum over j < nbs[b, 0] of table[ids[b, 0, j]]; every row of a short
    bag in flight before the first add."""
    return _row_sum('kD', ids, table, x, nbs=nbs)


def _shift(name, x):
    op, s = _SHIFTS[name]
    if not x.is_cuda:
        return _plain(name, x, x)
    out = (_ext or _bind()).shift(x, op, s, _stream(x.get_device()))
    if out is None:
        _reject(name, x, (('x', x, _F32, 3),))
    LAUNCHES[name] += 1
    return out


def kE(x):
    """x + roll(x, 3) along lanes (the TPU's pltpu.roll)."""
    return _shift('kE', x)


def kF(x):
    """x + roll(x, 3) along lanes (the TPU's jnp.roll): kE's kernel."""
    return _shift('kF', x)


def kG(x):
    """x + x shifted left by 4 along lanes, zero-filled."""
    return _shift('kG', x)


def kH(x):
    """x + roll(x, 1) along rows."""
    return _shift('kH', x)


def dummy(x):
    """P2: 2 x over the steps of x (nsteps, ...), a CTA per 4 KB tile, in
    and out of shared memory by the copy engine."""
    if not x.is_cuda:
        return _plain('dummy', x, x)
    out = (_ext or _bind()).dummy(x, _stream(x.get_device()))
    if out is None:
        _reject('dummy', x, (('x', x, _F32, None),))
    LAUNCHES['dummy'] += 1
    return out
