// Argument helpers of the extension modules' entry points (the
// ``<name>_module.cpp`` files, built by kaolin_tpu_torch/_cuda.py::
// load_module).  Each entry point is a METH_FASTCALL function: it reads its
// arguments with these, returns nullptr with a Python error set when an
// argument is not of its type, and None when a tensor fails its test (the
// Python wrapper then raises the precise error).

#pragma once

#include <Python.h>

#include <ATen/core/Tensor.h>
#include <torch/csrc/autograd/python_variable.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

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

// A contiguous ``dtype`` tensor of exactly ``sizes`` on CUDA device ``dev``,
// with fewer than 2^31 elements (the kernels index with ints).
inline bool shaped(const at::Tensor& t, at::ScalarType dtype,
                   c10::DeviceIndex dev,
                   std::initializer_list<int64_t> sizes) {
  return t.scalar_type() == dtype && t.is_cuda() && t.get_device() == dev &&
         t.sizes() == c10::IntArrayRef(sizes) && t.is_contiguous() &&
         t.numel() < INT_MAX;
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
