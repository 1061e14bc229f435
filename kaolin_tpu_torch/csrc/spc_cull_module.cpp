// Python entry point of the SPC culling kernel: the extension module
// ``spc_cull``, built with spc_cull.cu by kaolin_tpu_torch/_cuda.py::
// load_module and called by kaolin_tpu_torch/render/spc/raster.py::
// _cull_candidates_cuda.
//
// The entry point tests the inputs, allocates the outputs (and, where a
// super-tile's list does not fit in shared memory, its scratch) with
// PyTorch's allocator, and launches on the stream it is given, all in C++.
// It returns (n_b, blk_ids, sat).  An input the kernel does not take raises
// ValueError naming it (ext.h); a refused launch raises RuntimeError with
// the cudaError.

#include "ext.h"

#include <ATen/ops/empty.h>

extern "C" {
long long spc_cull_scratch(int cs);
int spc_cull(const void* blo, const void* bhi, const void* o, const void* d,
             void* n_b, void* blk_ids, void* sat, void* scratch, int nS,
             int rt, int Mc, int cs, int ck_max, void* stream);
}

namespace {

// cull(blo, bhi, o, d, cs, ck_max, stream)
//   -> (n_b (nB,) int64, blk_ids (nB, ck_max) int32, sat () bool):
// blo, bhi (Mc + 1, 3), o, d (nB, rt, 3) float32 on o's device, nB a
// multiple of 64, 1 <= rt <= 32
PyObject* py_cull(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int cs, ck_max;
  void* stream;
  if (!ext::args_ok(nargs, 7, "cull") || !ext::int_arg(args, 4, &cs) ||
      !ext::int_arg(args, 5, &ck_max) || !ext::stream_arg(args, 6, &stream))
    return nullptr;
  const at::Tensor* t[4];
  for (int k = 0; k < 4; ++k)
    if (!(t[k] = ext::tensor(args, k))) return nullptr;
  const at::Tensor &blo = *t[0], &bhi = *t[1], &o = *t[2], &d = *t[3];
  if (!ext::ranked(blo, "blo", 2) || !ext::ranked(o, "o", 3)) return nullptr;
  const int64_t M1 = blo.size(0), nB = o.size(0), rt = o.size(1);
  const int64_t nS = nB / 64;
  if (cs < 0 || ck_max < 0 || M1 < 1 || nB % 64 != 0 || rt < 1 || rt > 32)
    return PyErr_Format(PyExc_ValueError, "cull: cs = %d and ck_max = %d "
                        "must be at least 0, the cell table hold its dump "
                        "row, and o %s whole super-tiles of 64 blocks of 1 "
                        "to 32 rays", cs, ck_max,
                        ext::tuple(o.sizes()).c_str());
  const auto dev = o.get_device();
  if (!ext::shaped(blo, "blo", at::kFloat, dev, {M1, 3}) ||
      !ext::shaped(bhi, "bhi", at::kFloat, dev, {M1, 3}) ||
      !ext::shaped(o, "o", at::kFloat, dev, {nB, rt, 3}) ||
      !ext::shaped(d, "d", at::kFloat, dev, {nB, rt, 3}))
    return nullptr;
  if (nB * ck_max >= INT_MAX || nS * cs >= INT_MAX)
    return PyErr_Format(PyExc_ValueError, "cull: %lld block candidates and "
                        "%lld super-tile candidates, but the kernel indexes "
                        "with ints: fewer than 2^31", (long long)(nB * ck_max),
                        (long long)(nS * cs));
  const auto ints = o.options().dtype(at::kInt);
  at::Tensor n_b = at::empty({nB}, o.options().dtype(at::kLong));
  at::Tensor ids = at::empty({nB, (int64_t)ck_max}, ints);
  at::Tensor sat = at::empty(c10::IntArrayRef{}, o.options().dtype(at::kBool));
  at::Tensor scratch = at::empty({nS * spc_cull_scratch(cs)}, ints);
  if (!ext::launch_ok(
          spc_cull(blo.data_ptr(), bhi.data_ptr(), o.data_ptr(), d.data_ptr(),
                   n_b.data_ptr(), ids.data_ptr(), sat.data_ptr(),
                   scratch.numel() ? scratch.data_ptr() : nullptr, (int)nS,
                   (int)rt, (int)(M1 - 1), cs, ck_max, stream),
          "spc_cull_kernel"))
    return nullptr;
  PyObject* a = THPVariable_Wrap(std::move(n_b));
  PyObject* b = a ? THPVariable_Wrap(std::move(ids)) : nullptr;
  PyObject* c = b ? THPVariable_Wrap(std::move(sat)) : nullptr;
  PyObject* out = c ? PyTuple_Pack(3, a, b, c) : nullptr;
  Py_XDECREF(a);
  Py_XDECREF(b);
  Py_XDECREF(c);
  return out;
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"cull", (PyCFunction)(void (*)(void))py_cull, METH_FASTCALL,
     "cull(blo, bhi, o, d, cs, ck_max, stream) -> (n_b, blk_ids, sat)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "spc_cull",
                       "Launches of the SPC culling kernel.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_spc_cull(void) { return PyModule_Create(&kModule); }
