// Coherent-ray SPC trace kernel (K3) for Hopper (sm_90a), plain C interface:
// spc_trace.cuh's template at STAGE 6, with and without exit depths, the
// library's only instances.  Built by kaolin_tpu_torch/_cuda.py (nvcc
// -fmad=false) with spc_trace_module.cpp, its Python entry point.

#include "spc_trace.cuh"

// K3.  A live entry's pidx is its slot's leaf index + pidx_offset.
extern "C" int spc_trace(const void* rays, const void* cell_rows,
                         const void* block_cells, const void* nb,
                         const void* block_ids, void* tn_out, void* tf_out,
                         void* pi_out, void* cnt_out, int nA, int rt, int cw,
                         int ckmax, int kbuf, float side, int with_exit,
                         int pidx_offset, void* stream) {
  return launch<6>(rays, cell_rows, block_cells, nb, block_ids, tn_out,
                   tf_out, pi_out, cnt_out, nA, rt, cw, ckmax, kbuf, side,
                   with_exit, pidx_offset, stream);
}
