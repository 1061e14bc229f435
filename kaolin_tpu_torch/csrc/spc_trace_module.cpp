// Python entry point of K3: the extension module ``spc_trace``, built with
// spc_trace.cu by kaolin_tpu_torch/_cuda.py::load_module and called by
// kaolin_tpu_torch/render/spc/_trace.py::_launch.
//
// The wrapper allocates the outputs (their fills are the trace's
// defaults) and tests the launch's shape against the kernel's shared
// memory; this entry point tests the inputs (spc_trace_entry.h) and
// launches on the stream it is given, in C++.  It returns True when it
// launched and False when there was no active block to launch for.  An
// input the kernel does not take raises ValueError naming it; a refused
// launch raises RuntimeError with the cudaError.

#include "spc_trace_entry.h"

extern "C" int spc_trace(const void* rays, const void* cell_rows,
                         const void* block_cells, const void* nb,
                         const void* block_ids, void* tn_out, void* tf_out,
                         void* pi_out, void* cnt_out, int nA, int rt, int cw,
                         int ckmax, int kbuf, float side, int with_exit,
                         int pidx_offset, void* stream);

namespace {

// trace(rays, cell_rows, block_cells, nb, block_ids, t_near, t_far, pidx,
//       count, kbuf, side, with_exit, pidx_offset, stream) -> True or False
PyObject* py_trace(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  k3::Args a;
  void* stream;
  if (!ext::args_ok(nargs, 14, "trace") || !k3::read(args, &a) ||
      !ext::stream_arg(args, 13, &stream))
    return nullptr;
  if (a.nA == 0) Py_RETURN_FALSE;
  void* const* p = a.p;
  if (!ext::launch_ok(
          spc_trace(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                    a.nA, a.rt, a.cw, a.ckmax, a.kbuf, a.side, a.with_exit,
                    a.pidx_offset, stream),
          "spc_trace_kernel"))
    return nullptr;
  Py_RETURN_TRUE;
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"trace", (PyCFunction)(void (*)(void))py_trace, METH_FASTCALL,
     "trace(rays, cell_rows, block_cells, nb, block_ids, t_near, t_far, "
     "pidx, count, kbuf, side, with_exit, pidx_offset, stream) -> launched "
     "(K3)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "spc_trace",
                       "Launches of the SPC trace kernel K3.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_spc_trace(void) { return PyModule_Create(&kModule); }
