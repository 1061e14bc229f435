// Python entry points of the span marks: the extension module ``spans``,
// built with spans.cu by kaolin_tpu_torch/_cuda.py::load_module and called
// by kaolin_tpu_torch/utils/profiler.py::span.  A refused launch raises
// RuntimeError with the cudaError.

#include "ext.h"

extern "C" {
int spans_load();
int spans_mark(int id, int end, void* stream);
}

namespace {

// mark(id, end, stream) -> None
PyObject* py_mark(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  int id, end;
  void* stream;
  if (!ext::args_ok(nargs, 3, "mark") || !ext::int_arg(args, 0, &id) ||
      !ext::int_arg(args, 1, &end) || !ext::stream_arg(args, 2, &stream))
    return nullptr;
  if (!ext::launch_ok(spans_mark(id, end, stream), "kt_span mark"))
    return nullptr;
  Py_RETURN_NONE;
}

// load() -> None: every mark kernel loaded on the current device
PyObject* py_load(PyObject*, PyObject* const*, Py_ssize_t nargs) {
  if (!ext::args_ok(nargs, 0, "load")) return nullptr;
  if (!ext::launch_ok(spans_load(), "kt_span load")) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"mark", (PyCFunction)(void (*)(void))py_mark, METH_FASTCALL,
     "mark(id, end, stream): launch span id's begin (end=0) or end mark"},
    {"load", (PyCFunction)(void (*)(void))py_load, METH_FASTCALL,
     "load(): load every mark kernel on the current device"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "spans",
                       "Launches of the span marks.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_spans(void) { return PyModule_Create(&kModule); }
