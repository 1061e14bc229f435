"""The designs of the probe kernel P2 that the port weighed, on the card.

P2 (``scripts/probe_r5_stages.py::dummy_kernel``) is ``o = 2 x`` over
(8, 128) float32 steps: a copy in, a multiply, a copy out, bound by device
memory.  The package's kernel (``csrc/probes.cu::dummy_kernel``, through
:func:`~kaolin_tpu_torch.probes._kernels.dummy`) takes a CTA per step, a
bulk load and a bulk store through shared memory.  This probe builds the
other designs from ``p2_designs.cu`` beside it (a CTA per step with plain or
streaming 16-byte loads, persistent CTAs with 16-byte loads, persistent
rings of bulk-copied tiles, several tiles a CTA; the list is in the
source) and times each against ``torch.mul(x, 2.)`` at 65,536 and 262,144
steps: the device's time of one call (:func:`device_ms`, a CUDA graph of
``ITERS`` calls), taken in turns with ``torch.mul``
(:func:`~kaolin_tpu_torch.utils.measure.in_turns`), after one untimed graph
of each.  Every design is first held against ``2 x`` bit for bit.

``python -m kaolin_tpu_torch.probes.p2_designs`` runs it on the card and
prints the card and one JSON object (~1 min).
"""

import ctypes
from pathlib import Path

import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.probes import _kernels, main, same_bits, stages
from kaolin_tpu_torch.utils.measure import bound_ms, device_ms, in_turns

__all__ = ['DESIGNS', 'SOURCE', 'run']

SOURCE = Path(__file__).resolve().with_name('p2_designs.cu')
# names of the source's designs, in its order (its table kDesigns)
DESIGNS = ('a CTA a step, 16-byte loads',
           'a CTA a step, streaming 16-byte loads',
           'persistent, 16-byte loads',
           'persistent, streaming, 1 float4 in flight',
           'persistent, streaming, 4 float4s in flight',
           'persistent TMA ring, 2 x 4 KB',
           'persistent TMA ring, 3 x 4 KB',
           'persistent TMA ring, 4 x 4 KB',
           'persistent TMA ring, 2 x 16 KB',
           'persistent TMA loads, register stores, 4 x 4 KB',
           'TMA, 2 tiles a CTA', 'TMA, 4 tiles a CTA', 'TMA, 8 tiles a CTA')
PACKAGE = 'package: a CTA a step, TMA in and out'
ITERS = 20


def _build():
    """The designs' library, built by the package's builder with its nvcc
    flags (keyed by the source and the headers it includes)."""
    lib = ctypes.CDLL(str(_cuda.build('p2_designs', [SOURCE],
                                      _cuda.NVCC_FLAGS)))
    lib.p2_design_count.restype = ctypes.c_int
    lib.p2_design_grid.argtypes = [ctypes.c_int, ctypes.c_uint]
    lib.p2_design_grid.restype = ctypes.c_uint
    lib.p2_design.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    lib.p2_design.restype = ctypes.c_int
    if lib.p2_design_count() != len(DESIGNS):
        raise RuntimeError(f'{SOURCE.name} has {lib.p2_design_count()} '
                           f'designs, DESIGNS names {len(DESIGNS)}')
    return lib


def _caller(lib, which, x, stream):
    total4 = x.numel() // 4
    grid = lib.p2_design_grid(which, total4)

    def call():
        out = torch.empty_like(x)
        rc = lib.p2_design(which, x.data_ptr(), out.data_ptr(), total4, grid,
                           stream(x.get_device()))
        if rc:
            raise RuntimeError(f'P2 design {DESIGNS[which]!r} failed to '
                               f'launch: cudaError {rc}')
        return out
    return call, grid


def run(device='cuda', nsteps=stages.NSTEPS, iters=ITERS):
    """{nsteps: {design: dict(device_ms, library_device_ms, share of the
    bound, grid)}} with the bound, the package's kernel first; raises
    without CUDA or where a design differs from 2 x."""
    if torch.device(device).type != 'cuda':
        raise RuntimeError('p2_designs times the CUDA card')
    lib = _build()
    stream = _cuda.stream_getter()
    res = {}
    for n in nsteps:
        x = stages.dummy_inputs(n, device, seed=3)
        ref = x * 2.
        lib_call = lambda: torch.mul(x, 2.)
        calls = {PACKAGE: (lambda: _kernels.dummy(x), n)}
        for which, name in enumerate(DESIGNS):
            calls[name] = _caller(lib, which, x, stream)
        bound = bound_ms(*stages.dummy_work(n))[0]
        res[n] = dict(bound_ms=bound)
        for name, (call, grid) in calls.items():
            if not same_bits(call(), ref):
                raise RuntimeError(f'P2 design {name!r} differs from 2 x')
            device_ms(call, iters)
            device_ms(lib_call, iters)
            dev, lib_dev = in_turns(device_ms, call, lib_call, iters)
            res[n][name] = dict(device_ms=dev, library_device_ms=lib_dev,
                                share=bound / dev, grid=grid)
        del x, ref
        torch.cuda.empty_cache()
    return res


if __name__ == '__main__':
    main(run)
