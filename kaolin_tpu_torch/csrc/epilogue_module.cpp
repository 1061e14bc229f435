// Python entry points of E1-E3 and of the DIB-R shading: the extension
// module ``epilogue``, built with epilogue.cu by kaolin_tpu_torch/_cuda.py::
// load_module and called by kaolin_tpu_torch/render/mesh/_sample.py,
// kaolin_tpu_torch/ops/_scatter.py and kaolin_tpu_torch/render/mesh/
// _shade.py.
//
// Each entry point tests its inputs, allocates the outputs and the
// scratch with PyTorch's allocator, and launches on the stream it
// is given, all in C++.  The backwards order their ids with PyTorch's
// stable sort (at::sort(stable=true), a radix sort on the card: the one
// library step of E2 and E3, on the current stream, which is the stream
// given); the sums are epilogue.cu's.  On the stream that torch.cuda.graph
// captures, the allocations come from the graph's pool and the launches
// are recorded.
//
// Each returns the outputs.  An input the kernels do not take raises
// ValueError naming it (ext.h); a refused launch raises RuntimeError with
// the cudaError, and PyTorch's errors pass through as PyTorch raises them.

#include "ext.h"
#include "shade.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/sort.h>
#include <ATen/ops/zeros.h>

#include <initializer_list>

extern "C" {
long long epilogue_scratch(int M, int D);
int epilogue_bilinear_forward(const void* tex, const void* x, const void* y,
                              void* out, int Q, int P, int H, int W, int C,
                              void* stream);
int epilogue_bilinear_pixels(const void* tex, const void* x, const void* y,
                             const void* g, void* dx, void* dy, void* keys,
                             int Q, int P, int H, int W, int C, void* stream);
int epilogue_segment_sum(const void* sk, const void* perm, int M, int D,
                         int N, int taps_q, const void* g, const void* x,
                         const void* y, void* out, void* part, void* stream);
}

namespace {

// args[k..k+2] as the texture's (H, W) and the pixels per view P and
// args[k+3] as the stream, or false.
bool sample_args(PyObject* const* args, int k, int* H, int* W, int* P,
                 void** stream) {
  return ext::int_arg(args, k, H) && ext::int_arg(args, k + 1, W) &&
         ext::int_arg(args, k + 2, P) && ext::stream_arg(args, k + 3, stream);
}

// tex (B * H * W, C), x and y (Q,) with Q = B * P, all float32 on x's
// device; sets Q, C, or false with ValueError set.
bool sample_inputs(const at::Tensor& tex, const at::Tensor& x,
                   const at::Tensor& y, int H, int W, int P, int64_t* Q,
                   int64_t* C) {
  if (!ext::ranked(tex, "tex_rows", 2) || !ext::ranked(x, "x", 1))
    return false;
  *Q = x.size(0);
  *C = tex.size(1);
  if (H < 1 || W < 1 || P < 1 || *Q % P != 0 || *C < 1)
    return ext::fail("bilinear sample: texture %d x %d, P = %d pixels a view "
                     "and C = %lld channels must be at least 1, and x's %lld "
                     "pixels a multiple of P", H, W, P, (long long)*C,
                     (long long)*Q);
  const auto dev = x.get_device();
  return ext::shaped(tex, "tex_rows", at::kFloat, dev, {*Q / P * H * W, *C}) &&
         ext::shaped(x, "x", at::kFloat, dev, {*Q}) &&
         ext::shaped(y, "y", at::kFloat, dev, {*Q}) &&
         ((4 * *Q < INT_MAX && *Q * *C < INT_MAX) ||
          ext::fail("bilinear sample: 4 * %lld taps and %lld samples, but "
                    "the kernels index with ints: fewer than 2^31",
                    (long long)*Q, (long long)(*Q * *C)));
}

// The segment sums into out (N, D) (zero) of M entries with keys ``keys``.
bool segment_sum(const at::Tensor& keys, int64_t D, int64_t N, int taps_q,
                 const at::Tensor& g, const at::Tensor* x,
                 const at::Tensor* y, at::Tensor& out, void* stream) {
  const int M = (int)keys.numel();
  auto sorted = at::sort(keys, /*stable=*/true, 0, false);
  const at::Tensor& sk = std::get<0>(sorted);
  const at::Tensor& perm = std::get<1>(sorted);
  at::Tensor part =
      at::empty({(int64_t)epilogue_scratch(M, (int)D)}, g.options());
  return ext::launch_ok(
      epilogue_segment_sum(sk.data_ptr(), perm.data_ptr(), M, (int)D, (int)N,
                           taps_q, g.data_ptr(), x ? x->data_ptr() : nullptr,
                           y ? y->data_ptr() : nullptr, out.data_ptr(),
                           part.data_ptr(), stream),
      "segment_pieces_kernel");
}

// A tuple of the tensors, or nullptr with an error set.
PyObject* wrap_all(std::initializer_list<at::Tensor> ts) {
  PyObject* out = PyTuple_New((Py_ssize_t)ts.size());
  if (!out) return nullptr;
  Py_ssize_t i = 0;
  for (const at::Tensor& t : ts) {
    PyObject* o = THPVariable_Wrap(t);
    if (!o) {
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, i++, o);
  }
  return out;
}

// sample(tex, x, y, H, W, P, stream) -> (Q, C) float32 (E1)
PyObject* py_sample(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, P;
  void* stream;
  if (!ext::args_ok(nargs, 7, "sample") ||
      !sample_args(args, 3, &H, &W, &P, &stream))
    return nullptr;
  const at::Tensor* tex = ext::tensor(args, 0);
  const at::Tensor* x = ext::tensor(args, 1);
  const at::Tensor* y = ext::tensor(args, 2);
  if (!tex || !x || !y) return nullptr;
  int64_t Q, C;
  if (!sample_inputs(*tex, *x, *y, H, W, P, &Q, &C)) return nullptr;
  at::Tensor out = at::empty({Q, C}, x->options());
  if (!ext::launch_ok(
          epilogue_bilinear_forward(tex->data_ptr(), x->data_ptr(),
                                    y->data_ptr(), out.data_ptr(), (int)Q, P,
                                    H, W, (int)C, stream),
          "bilinear_forward_kernel"))
    return nullptr;
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

// sample_backward(tex, x, y, g, H, W, P, stream)
//   -> (dT (B * H * W, C), dx (Q,), dy (Q,)) float32 (E2)
PyObject* py_sample_backward(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int H, W, P;
  void* stream;
  if (!ext::args_ok(nargs, 8, "sample_backward") ||
      !sample_args(args, 4, &H, &W, &P, &stream))
    return nullptr;
  const at::Tensor* tex = ext::tensor(args, 0);
  const at::Tensor* x = ext::tensor(args, 1);
  const at::Tensor* y = ext::tensor(args, 2);
  const at::Tensor* g = ext::tensor(args, 3);
  if (!tex || !x || !y || !g) return nullptr;
  int64_t Q, C;
  if (!sample_inputs(*tex, *x, *y, H, W, P, &Q, &C) ||
      !ext::shaped(*g, "g", at::kFloat, x->get_device(), {Q, C}))
    return nullptr;
  at::Tensor dx = at::empty({Q}, x->options());
  at::Tensor dy = at::empty({Q}, x->options());
  at::Tensor keys = at::empty({4 * Q}, x->options().dtype(at::kInt));
  at::Tensor dt = at::zeros({tex->size(0), C}, x->options());
  if (!ext::launch_ok(
          epilogue_bilinear_pixels(tex->data_ptr(), x->data_ptr(),
                                   y->data_ptr(), g->data_ptr(),
                                   dx.data_ptr(), dy.data_ptr(),
                                   keys.data_ptr(), (int)Q, P, H, W, (int)C,
                                   stream),
          "bilinear_pixels_kernel") ||
      !segment_sum(keys, C, tex->size(0), (int)Q, *g, x, y, dt, stream))
    return nullptr;
  return wrap_all({dt, dx, dy});
  END_HANDLE_TH_ERRORS
}

// scatter_rows(g, idx, N, stream) -> (N, D) float32 (E3):
// g (P, D) float32, idx (P,) int32 on g's device
PyObject* py_scatter_rows(PyObject*, PyObject* const* args,
                          Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  int N;
  void* stream;
  if (!ext::args_ok(nargs, 4, "scatter_rows") ||
      !ext::int_arg(args, 2, &N) || !ext::stream_arg(args, 3, &stream))
    return nullptr;
  const at::Tensor* g = ext::tensor(args, 0);
  const at::Tensor* idx = ext::tensor(args, 1);
  if (!g || !idx || !ext::ranked(*g, "g", 2)) return nullptr;
  const int64_t P = g->size(0), D = g->size(1);
  if (N < 0 || D < 1)
    return PyErr_Format(PyExc_ValueError, "scatter_rows: N = %d rows must be "
                        "at least 0 and D = %lld columns at least 1", N,
                        (long long)D);
  const auto dev = g->get_device();
  if (!ext::shaped(*g, "g", at::kFloat, dev, {P, D}) ||
      !ext::shaped(*idx, "idx", at::kInt, dev, {P}))
    return nullptr;
  if ((int64_t)N * D >= INT_MAX)
    return PyErr_Format(PyExc_ValueError, "scatter_rows: %d rows of %lld "
                        "columns, but the kernels index with ints: fewer "
                        "than 2^31 elements", N, (long long)D);
  at::Tensor out = at::zeros({N, D}, g->options());
  if (!segment_sum(*idx, D, N, 0, *g, nullptr, nullptr, out, stream))
    return nullptr;
  return THPVariable_Wrap(std::move(out));
  END_HANDLE_TH_ERRORS
}

// args[k] as a double, or false with a Python error set.
bool double_arg(PyObject* const* args, int k, double* v) {
  *v = PyFloat_AsDouble(args[k]);
  return !(*v == -1. && PyErr_Occurred());
}

// The shading's inputs args[0..8], the texture's (TH, TW) args[k], args[k+1],
// multiplier and eps args[k+2], args[k+3] and the stream args[k+4]: fills
// in (B, H, W, F from the face ids and corners), or false with an error
// set.
bool shade_inputs(PyObject* const* args, int k, ShadeInputs* in,
                  void** stream, c10::DeviceIndex* dev) {
  const char* names[9] = {"face_idx", "face_vertices_image", "face_normals",
                          "face_uvs", "tex_rows", "sh_coeffs", "soft_mask",
                          "target_images", "target_masks"};
  const at::Tensor* t[9];
  for (int i = 0; i < 9; ++i)
    if (!(t[i] = ext::tensor(args, i))) return false;
  if (!ext::int_arg(args, k, &in->TH) || !ext::int_arg(args, k + 1, &in->TW) ||
      !double_arg(args, k + 2, &in->multiplier) ||
      !double_arg(args, k + 3, &in->eps) ||
      !ext::stream_arg(args, k + 4, stream) ||
      !ext::ranked(*t[0], names[0], 3) || !ext::ranked(*t[1], names[1], 4))
    return false;
  const int64_t B = t[0]->size(0), H = t[0]->size(1), W = t[0]->size(2),
                F = t[1]->size(1);
  if (B < 1 || H < 1 || W < 1 || F < 1 || in->TH < 1 || in->TW < 1)
    return ext::fail("shade: B = %lld views of H = %lld x W = %lld pixels, "
                     "F = %lld faces and a TH = %d x TW = %d texture must "
                     "each be at least 1", (long long)B, (long long)H,
                     (long long)W, (long long)F, in->TH, in->TW);
  if (B * H * W * 9 >= INT_MAX)
    return ext::fail("shade: %lld pixels of 9 face-row gradients, but the "
                     "kernels index with ints: fewer than 2^31",
                     (long long)(B * H * W));
  *dev = t[0]->get_device();
  const int64_t sizes[9][4] = {{B, H, W}, {B, F, 3, 2}, {B, F, 3}, {F, 3, 2},
                               {(int64_t)in->TH * in->TW, 3}, {9}, {B, H, W},
                               {B, H, W, 3}, {B, H, W}};
  const int ranks[9] = {3, 4, 3, 3, 2, 1, 3, 4, 3};
  for (int i = 0; i < 9; ++i)
    if (!ext::shaped(*t[i], names[i], i ? at::kFloat : at::kInt, *dev,
                     c10::IntArrayRef(sizes[i], ranks[i])))
      return false;
  in->face_idx = t[0]->data_ptr<int>();
  in->fvi = t[1]->data_ptr<float>();
  in->normals = t[2]->data_ptr<float>();
  in->face_uvs = t[3]->data_ptr<float>();
  in->tex = t[4]->data_ptr<float>();
  in->sh = t[5]->data_ptr<float>();
  in->soft_mask = t[6]->data_ptr<float>();
  in->target_images = t[7]->data_ptr<float>();
  in->target_masks = t[8]->data_ptr<float>();
  in->B = (int)B;
  in->H = (int)H;
  in->W = (int)W;
  in->F = (int)F;
  return true;
}

// shade(face_idx, fvi, normals, face_uvs, tex_rows, sh, soft_mask,
//       target_images, target_masks, TH, TW, multiplier, eps, stream)
//   -> (image_loss, mask_loss, iou (B, 2))
PyObject* py_shade(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  ShadeInputs in;
  void* stream;
  c10::DeviceIndex dev;
  if (!ext::args_ok(nargs, 14, "shade") ||
      !shade_inputs(args, 9, &in, &stream, &dev))
    return nullptr;
  const at::Tensor& fid = *ext::tensor(args, 0);
  const auto opt = fid.options().dtype(at::kFloat);
  at::Tensor part = at::empty({shade_blocks(in.B, in.H, in.W) * 3}, opt);
  at::Tensor image_loss = at::empty({}, opt);
  at::Tensor mask_loss = at::empty({}, opt);
  at::Tensor iou = at::empty({in.B, 2}, opt);
  if (!ext::launch_ok(
          epilogue_shade_forward(in, part.data_ptr<float>(),
                                 image_loss.data_ptr<float>(),
                                 mask_loss.data_ptr<float>(),
                                 iou.data_ptr<float>(), stream),
          "shade_forward_kernel"))
    return nullptr;
  return wrap_all({image_loss, mask_loss, iou});
  END_HANDLE_TH_ERRORS
}

// shade_backward(face_idx, fvi, normals, face_uvs, tex_rows, sh, soft_mask,
//                target_images, target_masks, iou, g_image, g_mask, TH, TW,
//                multiplier, eps, stream)
//   -> (d_albedo (Q, 3), tx (Q,), ty (Q,), rows (Q, 9), ids (Q,) int32,
//       d_soft (B, H, W), d_sh (9,)), Q = B * H * W
PyObject* py_shade_backward(PyObject*, PyObject* const* args,
                            Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  ShadeInputs in;
  void* stream;
  c10::DeviceIndex dev;
  if (!ext::args_ok(nargs, 17, "shade_backward") ||
      !shade_inputs(args, 12, &in, &stream, &dev))
    return nullptr;
  const at::Tensor* iou = ext::tensor(args, 9);
  const at::Tensor* g_image = ext::tensor(args, 10);
  const at::Tensor* g_mask = ext::tensor(args, 11);
  if (!iou || !g_image || !g_mask ||
      !ext::shaped(*iou, "iou", at::kFloat, dev, {in.B, 2}) ||
      !ext::shaped(*g_image, "g_image", at::kFloat, dev, {}) ||
      !ext::shaped(*g_mask, "g_mask", at::kFloat, dev, {}))
    return nullptr;
  const int64_t Q = (int64_t)in.B * in.H * in.W;
  const auto opt = iou->options();
  at::Tensor d_albedo = at::empty({Q, 3}, opt);
  at::Tensor tx = at::empty({Q}, opt);
  at::Tensor ty = at::empty({Q}, opt);
  at::Tensor rows = at::empty({Q, 9}, opt);
  at::Tensor ids = at::empty({Q}, opt.dtype(at::kInt));
  at::Tensor d_soft = at::empty({in.B, in.H, in.W}, opt);
  at::Tensor part = at::empty({shade_blocks(in.B, in.H, in.W) * 9}, opt);
  at::Tensor d_sh = at::empty({9}, opt);
  if (!ext::launch_ok(
          epilogue_shade_backward(
              in, iou->data_ptr<float>(), g_image->data_ptr<float>(),
              g_mask->data_ptr<float>(), d_albedo.data_ptr<float>(),
              tx.data_ptr<float>(), ty.data_ptr<float>(),
              rows.data_ptr<float>(), ids.data_ptr<int>(),
              d_soft.data_ptr<float>(), part.data_ptr<float>(),
              d_sh.data_ptr<float>(), stream),
          "shade_backward_kernel"))
    return nullptr;
  return wrap_all({d_albedo, tx, ty, rows, ids, d_soft, d_sh});
  END_HANDLE_TH_ERRORS
}

PyMethodDef kMethods[] = {
    {"sample", (PyCFunction)(void (*)(void))py_sample, METH_FASTCALL,
     "sample(tex, x, y, H, W, P, stream) -> out (E1)"},
    {"sample_backward", (PyCFunction)(void (*)(void))py_sample_backward,
     METH_FASTCALL,
     "sample_backward(tex, x, y, g, H, W, P, stream) -> (dT, dx, dy) (E2)"},
    {"scatter_rows", (PyCFunction)(void (*)(void))py_scatter_rows,
     METH_FASTCALL, "scatter_rows(g, idx, N, stream) -> out (E3)"},
    {"shade", (PyCFunction)(void (*)(void))py_shade, METH_FASTCALL,
     "shade(face_idx, fvi, normals, face_uvs, tex_rows, sh, soft_mask, "
     "target_images, target_masks, TH, TW, multiplier, eps, stream) -> "
     "(image_loss, mask_loss, iou)"},
    {"shade_backward", (PyCFunction)(void (*)(void))py_shade_backward,
     METH_FASTCALL,
     "shade_backward(face_idx, fvi, normals, face_uvs, tex_rows, sh, "
     "soft_mask, target_images, target_masks, iou, g_image, g_mask, TH, TW, "
     "multiplier, eps, stream) -> (d_albedo, tx, ty, rows, ids, d_soft, "
     "d_sh)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "epilogue",
    "Launches of the DIB-R epilogue kernels E1-E3 and of the shading.", -1,
    kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_epilogue(void) { return PyModule_Create(&kModule); }
