// Python entry points of K1 and K2: the extension module ``dibr_fused``,
// built with dibr_fused.cu by kaolin_tpu_torch/_cuda.py::load_module and
// called by kaolin_tpu_torch/render/mesh/_fused.py.
//
// Each entry point takes the wrapper's tensors, the image geometry the
// wrapper derives from (height, width, multiplier) and the stream, makes
// the wrapper's input test, allocates the outputs and the backward's
// scratch with PyTorch's allocator and launches, all in C++: the host work
// of one PyTorch op.  On the stream that torch.cuda.graph captures, the
// allocations come from the graph's pool and the launches are recorded.
//
// Each returns the outputs, or None for inputs that fail the test (the
// wrapper then raises the precise error); a refused launch raises
// RuntimeError with the cudaError, and PyTorch's errors (an allocation
// that fails) pass through as PyTorch raises them.

#include "ext.h"

#include <ATen/ops/empty.h>

extern "C" {
int dibr_fused_forward(const void* tile_ranges, const void* chunk_bbox,
                       const void* vt, void* fid, void* prod, int B, int nC,
                       int T, int H, int W, int nJ, int TW, float ax,
                       float bx, float ay, float by, float eps,
                       float inv_sigma, float sentinel, int with_softmask,
                       void* stream);
int dibr_fused_backward(const void* chunk_tranges, const void* chunk_bbox,
                        const void* vt, const void* gprod, void* active,
                        void* partial, void* out, int B, int nC, int S,
                        int T, int H, int W, int nJ, int TW, float ax,
                        float bx, float ay, float by, float inv_sigma,
                        float sentinel, void* stream);
}

namespace {

// faces per chunk and columns per face of vt (dibr_fused.cu, _fused.py)
constexpr int64_t FC = 64;
constexpr int64_t NCOL = 40;

// args[k..k+3] as the pixel affine (ax, bx, ay, by), or false.
bool affine_args(PyObject* const* args, int k, float* a) {
  for (int i = 0; i < 4; ++i)
    if (!ext::float_arg(args, k + i, a + i)) return false;
  return true;
}

// forward(vt, tile_ranges, chunk_bbox, H, W, T, nJ, TW, ax, bx, ay, by,
//         eps, inv_sigma, sentinel, with_softmask, stream)
//   -> (face_idx_sorted (B, H, W) int32, prod (B, H, W) float32) or None
PyObject* py_forward(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, T, nJ, TW, with_softmask;
  float a[4], eps, inv_sigma, sentinel;
  void* stream;
  if (!ext::args_ok(nargs, 17, "forward") || !ext::int_arg(args, 3, &H) ||
      !ext::int_arg(args, 4, &W) || !ext::int_arg(args, 5, &T) ||
      !ext::int_arg(args, 6, &nJ) || !ext::int_arg(args, 7, &TW) ||
      !affine_args(args, 8, a) || !ext::float_arg(args, 12, &eps) ||
      !ext::float_arg(args, 13, &inv_sigma) ||
      !ext::float_arg(args, 14, &sentinel) ||
      !ext::int_arg(args, 15, &with_softmask) ||
      !ext::stream_arg(args, 16, &stream))
    return nullptr;
  const at::Tensor* vt = ext::tensor(args, 0);
  const at::Tensor* tr = ext::tensor(args, 1);
  const at::Tensor* cbb = ext::tensor(args, 2);
  if (!vt || !tr || !cbb) return nullptr;
  if (vt->dim() != 4 || H < 0 || W < 0) Py_RETURN_NONE;
  const int64_t B = vt->size(0), nC = vt->size(1);
  const auto dev = vt->get_device();
  if (!ext::shaped(*vt, at::kFloat, dev, {B, nC, FC, NCOL}) ||
      !ext::shaped(*tr, at::kInt, dev, {B, T, 2}) ||
      !ext::shaped(*cbb, at::kFloat, dev, {B, nC, 4}) ||
      B * H * W >= INT_MAX)
    Py_RETURN_NONE;
  at::Tensor fid = at::empty({B, H, W}, vt->options().dtype(at::kInt));
  at::Tensor prod = at::empty({B, H, W}, vt->options());
  if (!ext::launch_ok(
          dibr_fused_forward(tr->data_ptr(), cbb->data_ptr(), vt->data_ptr(),
                             fid.data_ptr(), prod.data_ptr(), (int)B, (int)nC,
                             T, H, W, nJ, TW, a[0], a[1], a[2], a[3], eps,
                             inv_sigma, sentinel, with_softmask, stream),
          "fused_forward_kernel"))
    return nullptr;
  PyObject* f = THPVariable_Wrap(std::move(fid));
  PyObject* p = f ? THPVariable_Wrap(std::move(prod)) : nullptr;
  PyObject* out = p ? PyTuple_Pack(2, f, p) : nullptr;
  Py_XDECREF(f);
  Py_XDECREF(p);
  return out;
  END_HANDLE_TH_ERRORS
}

// backward(vt, chunk_tranges, chunk_bbox, g_prod, H, W, T, nJ, TW, S, U,
//          ax, bx, ay, by, inv_sigma, sentinel, stream)
//   -> (B, nC * FC, 6) float32 in sorted face order, or None;
//   S blocks per chunk, U units (8-row blocks of a tile) per view
PyObject* py_backward(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, T, nJ, TW, S, U;
  float a[4], inv_sigma, sentinel;
  void* stream;
  if (!ext::args_ok(nargs, 18, "backward") || !ext::int_arg(args, 4, &H) ||
      !ext::int_arg(args, 5, &W) || !ext::int_arg(args, 6, &T) ||
      !ext::int_arg(args, 7, &nJ) || !ext::int_arg(args, 8, &TW) ||
      !ext::int_arg(args, 9, &S) || !ext::int_arg(args, 10, &U) ||
      !affine_args(args, 11, a) || !ext::float_arg(args, 15, &inv_sigma) ||
      !ext::float_arg(args, 16, &sentinel) ||
      !ext::stream_arg(args, 17, &stream))
    return nullptr;
  const at::Tensor* vt = ext::tensor(args, 0);
  const at::Tensor* ctr = ext::tensor(args, 1);
  const at::Tensor* cbb = ext::tensor(args, 2);
  const at::Tensor* g = ext::tensor(args, 3);
  if (!vt || !ctr || !cbb || !g) return nullptr;
  if (vt->dim() != 4 || H < 0 || W < 0 || S < 1 || U < 0) Py_RETURN_NONE;
  const int64_t B = vt->size(0), nC = vt->size(1);
  const auto dev = vt->get_device();
  if (!ext::shaped(*vt, at::kFloat, dev, {B, nC, FC, NCOL}) ||
      !ext::shaped(*ctr, at::kInt, dev, {B, nC, 2}) ||
      !ext::shaped(*cbb, at::kFloat, dev, {B, nC, 4}) ||
      !ext::shaped(*g, at::kFloat, dev, {B, H, W}) ||
      B * nC * S * FC * 6 >= INT_MAX || B * U >= INT_MAX)
    Py_RETURN_NONE;
  at::Tensor active = at::empty({B, U}, vt->options().dtype(at::kInt));
  at::Tensor partial = at::empty({B, nC, S, FC, 6}, vt->options());
  at::Tensor out = at::empty({B, nC * FC, 6}, vt->options());
  if (!ext::launch_ok(
          dibr_fused_backward(ctr->data_ptr(), cbb->data_ptr(),
                              vt->data_ptr(), g->data_ptr(),
                              active.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), (int)B, (int)nC, S, T, H, W, nJ,
                              TW, a[0], a[1], a[2], a[3], inv_sigma, sentinel,
                              stream),
          "fused_backward_kernel"))
    return nullptr;
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"forward", (PyCFunction)(void (*)(void))py_forward, METH_FASTCALL,
     "forward(vt, tile_ranges, chunk_bbox, H, W, T, nJ, TW, ax, bx, ay, by, "
     "eps, inv_sigma, sentinel, with_softmask, stream) -> (fid, prod) or "
     "None (K1)"},
    {"backward", (PyCFunction)(void (*)(void))py_backward, METH_FASTCALL,
     "backward(vt, chunk_tranges, chunk_bbox, g_prod, H, W, T, nJ, TW, S, U, "
     "ax, bx, ay, by, inv_sigma, sentinel, stream) -> out or None (K2)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "dibr_fused",
                       "Launches of the DIB-R kernels K1 and K2.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_dibr_fused(void) { return PyModule_Create(&kModule); }
