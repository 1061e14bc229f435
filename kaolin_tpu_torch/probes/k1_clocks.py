"""Per-CTA clocks of the forward kernel K1 at the DIB-R cell.

K1 (``csrc/dibr_fused.cu::fused_forward_kernel``) runs one CTA per (16 x 16
sub-tile, view).  This probe builds a copy of that source into which it
writes, after a CTA's set-up and before its stores, reads of ``clock64()``
and ``%globaltimer``; the package's own build and kernel are untouched.
For each CTA it records its cycles, its face-list length, its chunk range,
its SM and its start and end in global time, and reports their spread:
how the cycles follow the list length, how long the last CTAs run alone,
and how busy the SMs are over the kernel's span.  The instrumented kernel's
outputs must equal the package kernel's bit for bit.

The inputs are ``chip_smoke.py``'s: ``uv_sphere(100, 51)`` perturbed by
0.05 N(0, 1) (numpy seed 0), 4 views, 512^2.
``python -m kaolin_tpu_torch.probes.k1_clocks`` runs it on the card and
prints the card and one JSON object.
"""

import ctypes
import hashlib
import subprocess

import numpy as np
import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.probes import main, same_bits
from kaolin_tpu_torch.render.mesh import _fused as FU
from kaolin_tpu_torch.utils.measure import time_ms
from kaolin_tpu_torch.utils.testing import uv_sphere

__all__ = ['patched_source', 'dibr_inputs', 'run']

MULT, SIGMAINV, BOXLEN, EPS = 1000., 7000., 0.02, 1e-8
MAX_CTAS = 1 << 16
# per CTA: cycles, face-list length, chunk range length, SM, start, end (ns)
NREC = 6

_HEADER = '#include <math.h>\n'
_START = ('  const Rect sub = pixel_rect(aff, r0, r0 + SUB - 1, c0, '
          'c0 + SUB - 1);\n')
_END = ('  if (wi < W && hrow < H) {            '
        '// padded pixels are not written\n')

_RECORDS = f'''
#define K1_CLOCK_MAX {MAX_CTAS}
__device__ long long k1_clock_rec[K1_CLOCK_MAX * {NREC}];
extern "C" int k1_clock_read(void* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, k1_clock_rec,
                                   (size_t)n * {NREC} * sizeof(long long));
}}
'''
_CLOCK0 = '''  const long long clk0 = clock64();
  unsigned long long gt0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt0));
'''
_CLOCK1 = '''  {
    const long long clk1 = clock64();
    unsigned long long gt1;
    unsigned smid;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && cta < K1_CLOCK_MAX) {
      long long* rec = k1_clock_rec + (size_t)cta * 6;
      rec[0] = clk1 - clk0;
      rec[1] = tail;
      rec[2] = hi - lo;
      rec[3] = smid;
      rec[4] = (long long)gt0;
      rec[5] = (long long)gt1;
    }
  }
'''


def patched_source():
    """``dibr_fused.cu`` with the clock reads written into K1; raises if an
    anchor is not found exactly once."""
    src = (_cuda.CSRC / 'dibr_fused.cu').read_text()
    for anchor, new in ((_HEADER, _HEADER + _RECORDS),
                        (_START, _START + _CLOCK0), (_END, _CLOCK1 + _END)):
        if src.count(anchor) != 1:
            raise RuntimeError(f'k1_clocks: anchor {anchor.strip()!r} found '
                               f'{src.count(anchor)} times in dibr_fused.cu')
        src = src.replace(anchor, new)
    return src


def _build():
    """Build the patched source into the build directory; its CDLL."""
    src = patched_source()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out_dir = _cuda.BUILD_DIR / 'k1_clocks'
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f'k1_clocks_{tag}.cu', out_dir / f'k1_clocks_{tag}.so'
    if not so.exists():
        cu.write_text(src)
        proc = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, '-o',
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on the patched source:\n'
                               f'{proc.stdout}{proc.stderr}')
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dibr_fused_forward.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, f, f, f, f, i, p]
    lib.dibr_fused_forward.restype = ctypes.c_int
    lib.k1_clock_read.argtypes = [p, i]
    lib.k1_clock_read.restype = ctypes.c_int
    return lib


def dibr_inputs(device, height=512, views=4, sphere=(100, 51)):
    """``build_face_tiles`` of chip_smoke.py's start point:
    (vt, tile_ranges, chunk_bbox, height)."""
    s = uv_sphere(*sphere)
    faces = torch.as_tensor(s.faces, device=device)
    cams = M.make_views(views, device=device)
    params = M.init_params(s, 8, device=device)
    noise = np.random.default_rng(0).standard_normal(
        tuple(params.vertices.shape)).astype(np.float32)
    with torch.no_grad():
        params.vertices += 0.05 * torch.as_tensor(noise, device=device)
        fvc, fvi, fn = M._prepare(params, cams, faces)
        vt, tr, _, cbb, _, _ = FU.build_face_tiles(
            fvc[..., 2], fvi * MULT, fn[..., 2] >= 0., height, height, MULT,
            BOXLEN * MULT)
    return vt.float().contiguous(), tr, cbb.float().contiguous(), height


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'{what} failed: cudaError {rc}')


def _launch(lib, vt, tr, cbb, H):
    """The instrumented K1 through its C entry (ctypes) on the current
    stream, outputs allocated here."""
    B, nC = vt.shape[:2]
    nI, nJ, TW = FU._tile_dims(*FU._padded_dims(H, H))
    ax, bx, ay, by = FU._pixel_affine(H, H, MULT)
    fid = torch.empty((B, H, H), dtype=torch.int32, device=vt.device)
    prod = torch.empty((B, H, H), dtype=torch.float32, device=vt.device)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (tr, cbb, vt, fid, prod)]
    stream = _cuda.stream_getter()(vt.get_device())
    rc = lib.dibr_fused_forward(
        *ptr, B, nC, nI * nJ, H, H, nJ, TW, ax, bx, ay, by, EPS,
        SIGMAINV / MULT ** 2, 4. * MULT ** 2, 1, ctypes.c_void_p(stream))
    _raise_on(rc, 'instrumented fused_forward_kernel launch')
    return fid, prod


def _busy_share(sm, t0, t1, span):
    """Mean over the SMs that ran a CTA of (union of CTA intervals) / span."""
    shares = []
    for s in np.unique(sm):
        iv = sorted(zip(t0[sm == s], t1[sm == s]))
        busy, end = 0, None
        for a, b in iv:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        shares.append(busy / span)
    return float(np.mean(shares))


def run(device):
    """Clock K1 once per CTA at the DIB-R cell; returns the spread."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('k1_clocks reads the clocks of the CUDA kernel')
    vt, tr, cbb, H = dibr_inputs(device)
    lib = _build()
    fid, prod = _launch(lib, vt, tr, cbb, H)
    ref = FU._fused_forward_cuda(vt, tr, cbb, H, H, MULT, EPS, SIGMAINV,
                                 True)
    torch.cuda.synchronize()
    B = vt.shape[0]
    nSI = -(-FU._padded_dims(H, H)[0] // FU._SUB)
    n = B * nSI * (FU._padded_dims(H, H)[1] // FU._SUB)
    rec = np.zeros((n, NREC), np.int64)
    _raise_on(lib.k1_clock_read(rec.ctypes.data, n), 'k1_clock_read')
    cyc, lst, rng, sm = (rec[:, k].astype(np.float64) for k in range(4))
    t0 = rec[:, 4] - rec[:, 4].min()
    t1 = rec[:, 5] - rec[:, 4].min()
    span = float(t1.max())
    fit = np.polyfit(lst, cyc, 1)
    done = np.sort(t1)
    q = dict(zip(('min', 'p50', 'mean', 'p90', 'p99', 'max'),
                 (cyc.min(), np.percentile(cyc, 50), cyc.mean(),
                  np.percentile(cyc, 90), np.percentile(cyc, 99),
                  cyc.max())))
    return dict(
        ctas=n, same_as_kernel=same_bits((fid, prod), ref),
        cycles=q, list_mean=lst.mean(), list_max=lst.max(),
        range_mean=rng.mean(),
        cycles_per_listed_face=fit[0], cycles_fixed=fit[1],
        corr_cycles_list=float(np.corrcoef(lst, cyc)[0, 1]),
        ghz=float(cyc.sum() / (t1 - t0).sum()),
        span_ns=span, ns_to_50pct_done=float(done[n // 2]),
        ns_to_90pct_done=float(done[int(n * 0.9)]),
        ctas_in_flight=float((t1 - t0).sum() / span),
        sm_busy_share=_busy_share(sm, t0, t1, span),
        sms=int(np.unique(sm).size),
        kernel_ms=time_ms(lambda: FU._fused_forward_cuda(
            vt, tr, cbb, H, H, MULT, EPS, SIGMAINV, True), 20),
        instrumented_ms=time_ms(lambda: _launch(lib, vt, tr, cbb, H), 20))


if __name__ == '__main__':
    main(run)
