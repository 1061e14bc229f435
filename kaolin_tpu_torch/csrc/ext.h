// Argument helpers of the extension modules' entry points (the
// ``<name>_module.cpp`` files, built by kaolin_tpu_torch/_cuda.py::
// load_module).  Each entry point is a METH_FASTCALL function: it reads and
// tests its arguments with these, and returns nullptr with a Python error
// set when one is not of its type (TypeError) or not what the kernel takes
// (ValueError, naming the argument).  The entry point is the one statement
// of its kernel's input contract: the Python wrappers test nothing again.

#pragma once

#include <Python.h>

#include <ATen/core/Tensor.h>
#include <torch/csrc/DynamicTypes.h>
#include <torch/csrc/autograd/python_variable.h>

#include <climits>
#include <cstdint>
#include <string>

namespace ext {

// args[k] as a tensor, or nullptr with a Python error set.
inline const at::Tensor* tensor(PyObject* const* args, int k) {
  if (!THPVariable_Check(args[k])) {
    PyErr_Format(PyExc_TypeError, "argument %d: expected a tensor", k);
    return nullptr;
  }
  return &THPVariable_Unpack(args[k]);
}

inline bool args_ok(Py_ssize_t nargs, Py_ssize_t want, const char* entry) {
  if (nargs == want) return true;
  PyErr_Format(PyExc_TypeError, "%s takes %zd arguments, got %zd", entry,
               want, nargs);
  return false;
}

// args[k] as an int, or false with a Python error set.
inline bool int_arg(PyObject* const* args, int k, int* v) {
  const long x = PyLong_AsLong(args[k]);
  if (x == -1 && PyErr_Occurred()) return false;
  if (x < INT_MIN || x > INT_MAX) {
    PyErr_Format(PyExc_OverflowError, "argument %d does not fit an int", k);
    return false;
  }
  *v = (int)x;
  return true;
}

// args[k] as a float, rounded to nearest as ctypes.c_float rounds it, or
// false with a Python error set.
inline bool float_arg(PyObject* const* args, int k, float* v) {
  const double x = PyFloat_AsDouble(args[k]);
  if (x == -1. && PyErr_Occurred()) return false;
  *v = (float)x;
  return true;
}

// args[k] (a stream handle as an int) as a pointer, or false.
inline bool stream_arg(PyObject* const* args, int k, void** v) {
  *v = PyLong_AsVoidPtr(args[k]);
  return !PyErr_Occurred();
}

// False with ValueError (fmt, args) set.
template <class... A>
bool fail(const char* fmt, A... args) {
  PyErr_Format(PyExc_ValueError, fmt, args...);
  return false;
}

// Sizes as Python prints a tuple: (), (5,), (2, 3).
inline std::string tuple(c10::IntArrayRef sizes) {
  std::string s = "(";
  for (size_t i = 0; i < sizes.size(); ++i)
    s += (i ? ", " : "") + std::to_string(sizes[i]);
  return s + (sizes.size() == 1 ? ",)" : ")");
}

// ``t`` with ``dim`` dims, or false with ValueError "<name>: expected a
// <dim>-d tensor, got shape <shape>" set.
inline bool ranked(const at::Tensor& t, const char* name, int64_t dim) {
  return t.dim() == dim || fail("%s: expected a %d-d tensor, got shape %s",
                                name, (int)dim, tuple(t.sizes()).c_str());
}

// A contiguous ``dtype`` tensor of exactly ``sizes`` on CUDA device ``dev``,
// with fewer than 2^31 elements (the kernels index with ints), or false with
// ValueError set: "<name>: expected a contiguous <dtype> tensor of shape
// <sizes> on cuda:<dev>, got <dtype> <shape> on <device>
// (contiguous=<bool>)", or the element count.
inline bool shaped(const at::Tensor& t, const char* name,
                   at::ScalarType dtype, c10::DeviceIndex dev,
                   c10::IntArrayRef sizes) {
  if (t.scalar_type() == dtype && t.is_cuda() && t.get_device() == dev &&
      t.sizes() == sizes && t.is_contiguous())
    return t.numel() < INT_MAX ||
           fail("%s: %lld elements, but the kernels index with ints: fewer "
                "than 2^31", name, (long long)t.numel());
  return fail("%s: expected a contiguous %S tensor of shape %s on %s, got %S "
              "%s on %s (contiguous=%s)", name,
              (PyObject*)torch::getTHPDtype(dtype), tuple(sizes).c_str(),
              c10::Device(c10::kCUDA, dev).str().c_str(),
              (PyObject*)torch::getTHPDtype(t.scalar_type()),
              tuple(t.sizes()).c_str(), t.device().str().c_str(),
              t.is_contiguous() ? "True" : "False");
}

// False with RuntimeError "<what> failed to launch: cudaError <rc>" set
// where rc != 0.
inline bool launch_ok(int rc, const char* what) {
  if (rc == 0) return true;
  PyErr_Format(PyExc_RuntimeError, "%s failed to launch: cudaError %d", what,
               rc);
  return false;
}

}  // namespace ext
