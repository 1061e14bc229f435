// The input test of K3's entry points, spc_trace_module.cpp's ``trace`` and
// probes_module.cpp's ``trace_stage`` (P3: K3 cut at a stage).

#pragma once

#include "ext.h"

namespace k3 {

// K3's launch arguments but the stream: the data of rays, cell_rows,
// block_cells, nb, block_ids, t_near, t_far, pidx and count, then scalars.
struct Args {
  void* p[9];
  int nA, rt, cw, ckmax, kbuf, with_exit, pidx_offset;
  float side;
};

// args[0..12] = (rays, cell_rows, block_cells, nb, block_ids, t_near, t_far,
// pidx, count, kbuf, side, with_exit, pidx_offset) into *a, or false with a
// Python error set.
inline bool read(PyObject* const* args, Args* a) {
  if (!ext::int_arg(args, 9, &a->kbuf) ||
      !ext::float_arg(args, 10, &a->side) ||
      !ext::int_arg(args, 11, &a->with_exit) ||
      !ext::int_arg(args, 12, &a->pidx_offset))
    return false;
  const at::Tensor* t[9];
  for (int k = 0; k < 9; ++k)
    if (!(t[k] = ext::tensor(args, k))) return false;
  if (!ext::ranked(*t[0], "rays", 3) || !ext::ranked(*t[1], "cell_rows", 3) ||
      !ext::ranked(*t[2], "block_cells", 2) || !ext::ranked(*t[8], "count", 2))
    return false;
  const int64_t nA = t[0]->size(0), rt = t[0]->size(1), cw = t[1]->size(2),
                ckmax = t[2]->size(1), nB = t[8]->size(0), kbuf = a->kbuf;
  const auto dev = t[0]->get_device();
  if (!ext::shaped(*t[0], "rays", at::kFloat, dev, {nA, rt, 6}) ||
      !ext::shaped(*t[1], "cell_rows", at::kInt, dev,
                   {t[1]->size(0), 4, cw}) ||
      !ext::shaped(*t[2], "block_cells", at::kInt, dev, {nA, ckmax}) ||
      !ext::shaped(*t[3], "nb", at::kInt, dev, {nA}) ||
      !ext::shaped(*t[4], "block_ids", at::kLong, dev, {nA}) ||
      !ext::shaped(*t[5], "t_near", at::kFloat, dev, {nB, rt, kbuf}) ||
      !ext::shaped(*t[6], "t_far", at::kFloat, dev, {nB, rt, kbuf}) ||
      !ext::shaped(*t[7], "pidx", at::kInt, dev, {nB, rt, kbuf}) ||
      !ext::shaped(*t[8], "count", at::kInt, dev, {nB, rt}))
    return false;
  for (int k = 0; k < 9; ++k) a->p[k] = t[k]->data_ptr();
  a->nA = (int)nA;
  a->rt = (int)rt;
  a->cw = (int)cw;
  a->ckmax = (int)ckmax;
  return true;
}

}  // namespace k3
