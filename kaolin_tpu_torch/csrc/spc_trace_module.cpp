// Python entry point of K3 (and of its cuts at stages 1-5, P3): the
// extension module ``spc_trace``, built with spc_trace.cu by
// kaolin_tpu_torch/_cuda.py::load_module and called by
// kaolin_tpu_torch/render/spc/_trace.py::_launch.
//
// The wrapper allocates the outputs (their fills are the trace's
// defaults) and tests the launch's shape against the kernel's shared
// memory; this entry point makes its input test and launches on the stream
// it is given, in C++.  It returns True when it launched, False when there
// was no active block to launch for, and None for inputs that fail the
// test (the wrapper then raises the precise error); a refused launch
// raises RuntimeError with the cudaError.

#include "ext.h"

extern "C" int spc_trace(const void* rays, const void* cell_rows,
                         const void* block_cells, const void* nb,
                         const void* block_ids, void* tn_out, void* tf_out,
                         void* pi_out, void* cnt_out, int nA, int rt, int cw,
                         int ckmax, int kbuf, float side, int with_exit,
                         int pidx_offset, int stage, void* stream);

namespace {

// trace(rays, cell_rows, block_cells, nb, block_ids, t_near, t_far, pidx,
//       count, kbuf, side, with_exit, pidx_offset, stage, stream)
//   -> True, False or None
PyObject* py_trace(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  float side;
  int kbuf, with_exit, pidx_offset, stage;
  void* stream;
  if (!ext::args_ok(nargs, 15, "trace") || !ext::int_arg(args, 9, &kbuf) ||
      !ext::float_arg(args, 10, &side) ||
      !ext::int_arg(args, 11, &with_exit) ||
      !ext::int_arg(args, 12, &pidx_offset) ||
      !ext::int_arg(args, 13, &stage) || !ext::stream_arg(args, 14, &stream))
    return nullptr;
  const at::Tensor* t[9];
  for (int k = 0; k < 9; ++k)
    if (!(t[k] = ext::tensor(args, k))) return nullptr;
  const at::Tensor &rays = *t[0], &rows = *t[1], &cells = *t[2], &nb = *t[3],
                   &ids = *t[4], &tn = *t[5], &tf = *t[6], &pi = *t[7],
                   &cnt = *t[8];
  if (rays.dim() != 3 || rows.dim() != 3 || cells.dim() != 2 ||
      cnt.dim() != 2)
    Py_RETURN_NONE;
  const int64_t nA = rays.size(0), rt = rays.size(1), cw = rows.size(2),
                ckmax = cells.size(1), nB = cnt.size(0);
  const auto dev = rays.get_device();
  if (!ext::shaped(rays, at::kFloat, dev, {nA, rt, 6}) ||
      !ext::shaped(rows, at::kInt, dev, {rows.size(0), 4, cw}) ||
      !ext::shaped(cells, at::kInt, dev, {nA, ckmax}) ||
      !ext::shaped(nb, at::kInt, dev, {nA}) ||
      !ext::shaped(ids, at::kLong, dev, {nA}) ||
      !ext::shaped(tn, at::kFloat, dev, {nB, rt, kbuf}) ||
      !ext::shaped(tf, at::kFloat, dev, {nB, rt, kbuf}) ||
      !ext::shaped(pi, at::kInt, dev, {nB, rt, kbuf}) ||
      !ext::shaped(cnt, at::kInt, dev, {nB, rt}))
    Py_RETURN_NONE;
  if (nA == 0) Py_RETURN_FALSE;
  if (!ext::launch_ok(
          spc_trace(rays.data_ptr(), rows.data_ptr(), cells.data_ptr(),
                    nb.data_ptr(), ids.data_ptr(), tn.data_ptr(),
                    tf.data_ptr(), pi.data_ptr(), cnt.data_ptr(), (int)nA,
                    (int)rt, (int)cw, (int)ckmax, kbuf, side, with_exit,
                    pidx_offset, stage, stream),
          "spc_trace_kernel"))
    return nullptr;
  Py_RETURN_TRUE;
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"trace", (PyCFunction)(void (*)(void))py_trace, METH_FASTCALL,
     "trace(rays, cell_rows, block_cells, nb, block_ids, t_near, t_far, "
     "pidx, count, kbuf, side, with_exit, pidx_offset, stage, stream) -> "
     "launched, or None (K3; stages 1-5: P3)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "spc_trace",
                       "Launches of the SPC trace kernel K3.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_spc_trace(void) { return PyModule_Create(&kModule); }
