"""Probe kernels P1 (kA..kH) and P2 (the dummy grid): wrappers and plain
versions.

Ports of the Pallas TPU probes ``scripts/probe_r5_mosaic3.py::kA..kH`` and
``scripts/probe_r5_stages.py::dummy_kernel``; the CUDA kernels are in
``csrc/probes.cu``.  Layouts follow the scripts: ``x`` is (NB, R, C)
float32 (one CTA per b), ``nbs`` is (NB, 2) int32 of which column 0 is
read, ``ids`` is (NB, 1, CK) int32 rows of ``table`` (M, R, C) float32.

CPU tensors run the plain PyTorch versions (``PLAIN``); CUDA tensors
launch the kernel or raise.  ``LAUNCHES`` counts launches by
wrapper name.  Every kernel equals its plain version bit for bit: the sums
run in the scripts' order.
"""

import ctypes

import torch

__all__ = ['kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH', 'dummy',
           'LAUNCHES', 'PLAIN']

LAUNCHES = {k: 0 for k in ('kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH',
                           'dummy')}

ROLL_LANES, SHIFT_LANES, ROLL_ROWS = 0, 1, 2     # probe_shift's ops
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
    'kC': lambda ids, table, x: _row_sum_torch(ids, table),
    'kD': lambda nbs, ids, table, x: _row_sum_torch(ids, table, nbs[:, 0]),
    'kE': lambda x: _shift_torch(x, *_SHIFTS['kE']),
    'kF': lambda x: _shift_torch(x, *_SHIFTS['kF']),
    'kG': lambda x: _shift_torch(x, *_SHIFTS['kG']),
    'kH': lambda x: _shift_torch(x, *_SHIFTS['kH']),
    'dummy': _dummy_torch,
}


# ---------------------------------------------------------------------------
# CUDA launches

def _lib():
    from kaolin_tpu_torch import _cuda
    lib = _cuda.load('probes')
    if lib.probe_dummy.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((lib.probe_dyn_loop, [p, i, p, p, i, i, p]),
                         (lib.probe_row_sum, [p, i, p, i, p, p, i, i, i, i,
                                              p]),
                         (lib.probe_shift, [p, p, i, i, i, i, i, p]),
                         (lib.probe_dummy, [p, p, i, i, p])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, ndim, device):
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f'{name}: expected a contiguous, 16-byte aligned {dtype} tensor '
            f'of {ndim} dims on {device}, got {t.dtype} {tuple(t.shape)} on '
            f'{t.device}')


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f'probe kernel {name} failed to launch: '
                           f'cudaError {rc}')
    LAUNCHES[name] += 1


def _on_card(x):
    """True: run the kernel; False: the plain version (CPU tensor)."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'no probe kernel for device {x.device}')
    return True


def _check_nbs(nbs, nb, device):
    _check('nbs', nbs, torch.int32, 2, device)
    if nbs.shape[0] != nb:
        raise ValueError(f'nbs: expected {nb} rows, got {nbs.shape[0]}')


def _row_sum(name, ids, table, x, nbs=None, slots=1):
    if not _on_card(x):
        return (PLAIN[name](ids, table, x) if nbs is None
                else PLAIN[name](nbs, ids, table, x))
    device = x.device
    nb = x.shape[0]
    _check('ids', ids, torch.int32, 3, device)
    _check('table', table, torch.float32, table.dim(), device)
    if ids.shape[:2] != (nb, 1) or tuple(table.shape[1:]) != tuple(
            x.shape[1:]):
        raise ValueError(f'{name}: ids must be ({nb}, 1, CK) and table rows '
                         f'shaped like x[b]; got ids {tuple(ids.shape)}, '
                         f'table {tuple(table.shape)}, x {tuple(x.shape)}')
    if nbs is not None:
        _check_nbs(nbs, nb, device)
    n = x[0].numel()
    out = torch.empty_like(x)
    rc = _lib().probe_row_sum(
        _ptr(ids), ids.shape[2], _ptr(nbs if nbs is not None else ids),
        2, _ptr(table), _ptr(out), nb, n, slots, int(nbs is not None),
        _stream(device))
    _launched(name, rc)
    return out


def kA(nbs, x):
    """x[b] added nbs[b, 0] times, from 0 (a loop bound read at run
    time)."""
    if not _on_card(x):
        return _kA_torch(nbs, x)
    _check('x', x, torch.float32, x.dim(), x.device)
    _check_nbs(nbs, x.shape[0], x.device)
    out = torch.empty_like(x)
    rc = _lib().probe_dyn_loop(_ptr(nbs), 2, _ptr(x), _ptr(out), x.shape[0],
                               x[0].numel(), _stream(x.device))
    _launched('kA', rc)
    return out


def kB(ids, table, x):
    """sum over j < CK of table[ids[b, 0, j]]; rows double-buffered."""
    return _row_sum('kB', ids, table, x, slots=2)


def kC(ids, table, x):
    """The same sum, one row buffer."""
    return _row_sum('kC', ids, table, x)


def kD(nbs, ids, table, x):
    """sum over j < nbs[b, 0] of table[ids[b, 0, j]], one row buffer."""
    return _row_sum('kD', ids, table, x, nbs=nbs)


def _shift(name, x):
    op, s = _SHIFTS[name]
    if not _on_card(x):
        return _shift_torch(x, op, s)
    _check('x', x, torch.float32, 3, x.device)
    out = torch.empty_like(x)
    rc = _lib().probe_shift(_ptr(x), _ptr(out), x.shape[0], x.shape[1],
                            x.shape[2], op, s, _stream(x.device))
    _launched(name, rc)
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
    """P2: 2 x, one CTA per step of x (nsteps, ...)."""
    if not _on_card(x):
        return _dummy_torch(x)
    _check('x', x, torch.float32, x.dim(), x.device)
    out = torch.empty_like(x)
    rc = _lib().probe_dummy(_ptr(x), _ptr(out), x.shape[0], x[0].numel(),
                            _stream(x.device))
    _launched('dummy', rc)
    return out
