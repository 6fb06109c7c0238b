/*
 * lib_lightgbm_torch.so — the C API surface of lightgbm_tpu_torch.
 *
 * Reference: src/c_api.cpp + include/LightGBM/c_api.h:29-527 (38
 * LGBM_* exports, DatasetHandle/BoosterHandle opaque pointers,
 * thread-local last-error with the API_BEGIN/API_END trap,
 * c_api.h:547-573).
 *
 * A copy of the JAX package's shim (src_native/c_api_shim.cpp) that
 * forwards to lightgbm_tpu_torch.capi_bridge instead: it embeds
 * CPython and forwards every call to the bridge, which does all
 * pointer marshalling with ctypes/numpy. Handles are strong PyObject
 * references released by the matching *Free call. Every entry point
 * takes the GIL, so the library is callable from any thread, from a
 * host Python process (ctypes) or from a plain C program. Its exports
 * carry the same LGBM_* names as lib_lightgbm.so: load it with
 * RTLD_LOCAL (ctypes' default) beside the other.
 *
 * Built with g++ at first use by lightgbm_tpu_torch/native/__init__.py.
 */

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <string>

#define DllExport extern "C" __attribute__((visibility("default")))

typedef void* DatasetHandle;
typedef void* BoosterHandle;

static thread_local std::string g_last_error = "Everything is fine";

DllExport const char* LGBM_GetLastError() { return g_last_error.c_str(); }

/* c_api.h:554-556 keeps this inline for in-process use; exporting it
 * lets FFI hosts stamp their own error text into the same thread-local
 * slot GetLastError reads. */
DllExport void LGBM_SetLastError(const char* msg) {
  g_last_error = msg ? msg : "";
}

namespace {

PyObject* g_bridge = nullptr;

/* Initialize the interpreter (when hosted by a non-Python process) and
 * import the bridge module once. Returns borrowed bridge ref or null. */
PyObject* bridge() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
#if PY_VERSION_HEX < 0x03090000
    PyEval_InitThreads();
#endif
  }
  if (g_bridge == nullptr) {
    PyGILState_STATE st = PyGILState_Ensure();
    g_bridge = PyImport_ImportModule("lightgbm_tpu_torch.capi_bridge");
    if (g_bridge == nullptr) {
      PyErr_Print();
    }
    PyGILState_Release(st);
  }
  return g_bridge;
}

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* msg = PyUnicode_AsUTF8(s);
      g_last_error = msg != nullptr ? msg : "unknown error";
      Py_DECREF(s);
    }
  } else {
    g_last_error = "unknown error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

/* Call bridge.<name>(*args). Returns new ref or null (error stored). */
PyObject* call(const char* name, const char* fmt, ...) {
  PyObject* mod = bridge();
  if (mod == nullptr) {
    g_last_error = "lightgbm_tpu_torch.capi_bridge import failed";
    return nullptr;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  va_list vargs;
  va_start(vargs, fmt);
  PyObject* args = Py_VaBuildValue(fmt, vargs);
  va_end(vargs);
  PyObject* result = nullptr;
  if (args != nullptr) {
    PyObject* fn = PyObject_GetAttrString(mod, name);
    if (fn != nullptr) {
      result = PyObject_CallObject(fn, args);
      Py_DECREF(fn);
    }
    Py_DECREF(args);
  }
  if (result == nullptr) {
    set_error_from_python();
  }
  PyGILState_Release(st);
  return result;
}

/* Store a new-ref result as an opaque handle (keeps the strong ref). */
int to_handle(PyObject* result, void** out) {
  if (result == nullptr) return -1;
  *out = static_cast<void*>(result);
  return 0;
}

/* Result ignored beyond success/failure.
 * NOTE: must not touch thread state before PyGILState_Ensure — ctypes
 * callers release the GIL around the C call, so this thread does not
 * hold it on entry. */
int to_status(PyObject* result) {
  if (result == nullptr) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_DECREF(result);
  PyGILState_Release(st);
  return 0;
}

/* Result is an int scalar written to *out. */
template <typename T>
int to_int(PyObject* result, T* out) {
  if (result == nullptr) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  *out = static_cast<T>(PyLong_AsLongLong(result));
  Py_DECREF(result);
  PyGILState_Release(st);
  return 0;
}

int free_handle(void* handle) {
  if (handle != nullptr) {
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF(static_cast<PyObject*>(handle));
    PyGILState_Release(st);
  }
  return 0;
}

PyObject* none_or(void* handle) {
  /* borrowed-ref helper for optional handle args ("O" format) */
  return handle != nullptr ? static_cast<PyObject*>(handle) : Py_None;
}

}  // namespace

/* ----------------------------------------------------------- datasets */

DllExport int LGBM_DatasetCreateFromFile(const char* filename,
                                         const char* parameters,
                                         const DatasetHandle reference,
                                         DatasetHandle* out) {
  return to_handle(call("dataset_create_from_file", "(ssO)", filename,
                        parameters, none_or(reference)),
                   out);
}

DllExport int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                                        const int32_t* indices,
                                        const void* data, int data_type,
                                        int64_t nindptr, int64_t nelem,
                                        int64_t num_col,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out) {
  return to_handle(
      call("dataset_create_from_csr", "(KiKKiLLLsO)", (unsigned long long)indptr,
           indptr_type, (unsigned long long)indices, (unsigned long long)data,
           data_type, (long long)nindptr, (long long)nelem, (long long)num_col,
           parameters, none_or(reference)),
      out);
}

DllExport int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                                        const int32_t* indices,
                                        const void* data, int data_type,
                                        int64_t ncol_ptr, int64_t nelem,
                                        int64_t num_row,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out) {
  return to_handle(
      call("dataset_create_from_csc", "(KiKKiLLLsO)",
           (unsigned long long)col_ptr, col_ptr_type,
           (unsigned long long)indices, (unsigned long long)data, data_type,
           (long long)ncol_ptr, (long long)nelem, (long long)num_row,
           parameters, none_or(reference)),
      out);
}

DllExport int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                        int32_t nrow, int32_t ncol,
                                        int is_row_major,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out) {
  return to_handle(call("dataset_create_from_mat", "(KiiiisO)",
                        (unsigned long long)data, data_type, (int)nrow,
                        (int)ncol, is_row_major, parameters,
                        none_or(reference)),
                   out);
}

DllExport int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                    const int32_t* used_row_indices,
                                    int32_t num_used_row_indices,
                                    const char* parameters,
                                    DatasetHandle* out) {
  return to_handle(call("dataset_get_subset", "(OKis)", none_or(handle),
                        (unsigned long long)used_row_indices,
                        (int)num_used_row_indices, parameters),
                   out);
}

DllExport int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                          const char** feature_names,
                                          int64_t num_feature_names) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* names = PyList_New(num_feature_names);
  for (int64_t i = 0; i < num_feature_names; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(feature_names[i]));
  }
  PyGILState_Release(st);
  int ret = to_status(call("dataset_set_feature_names", "(ON)",
                           none_or(handle), names));
  return ret;
}

DllExport int LGBM_DatasetFree(DatasetHandle handle) {
  return free_handle(handle);
}

DllExport int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                     const char* filename) {
  return to_status(call("dataset_save_binary", "(Os)", none_or(handle),
                        filename));
}

DllExport int LGBM_DatasetSetField(DatasetHandle handle,
                                   const char* field_name,
                                   const void* field_data,
                                   int64_t num_element, int type) {
  return to_status(call("dataset_set_field", "(OsKLi)", none_or(handle),
                        field_name, (unsigned long long)field_data,
                        (long long)num_element, type));
}

DllExport int LGBM_DatasetGetField(DatasetHandle handle,
                                   const char* field_name, int64_t* out_len,
                                   const void** out_ptr, int* out_type) {
  return to_status(call("dataset_get_field", "(OsKKK)", none_or(handle),
                        field_name, (unsigned long long)out_len,
                        (unsigned long long)out_ptr,
                        (unsigned long long)out_type));
}

DllExport int LGBM_DatasetGetNumData(DatasetHandle handle, int64_t* out) {
  return to_int(call("dataset_get_num_data", "(O)", none_or(handle)), out);
}

DllExport int LGBM_DatasetGetNumFeature(DatasetHandle handle, int64_t* out) {
  return to_int(call("dataset_get_num_feature", "(O)", none_or(handle)), out);
}

/* ----------------------------------------------------------- boosters */

DllExport int LGBM_BoosterCreate(const DatasetHandle train_data,
                                 const char* parameters, BoosterHandle* out) {
  return to_handle(call("booster_create", "(Os)", none_or(train_data),
                        parameters),
                   out);
}

DllExport int LGBM_BoosterCreateFromModelfile(const char* filename,
                                              int64_t* out_num_iterations,
                                              BoosterHandle* out) {
  return to_handle(call("booster_create_from_modelfile", "(sK)", filename,
                        (unsigned long long)out_num_iterations),
                   out);
}

DllExport int LGBM_BoosterFree(BoosterHandle handle) {
  return free_handle(handle);
}

DllExport int LGBM_BoosterMerge(BoosterHandle handle,
                                BoosterHandle other_handle) {
  return to_status(call("booster_merge", "(OO)", none_or(handle),
                        none_or(other_handle)));
}

DllExport int LGBM_BoosterAddValidData(BoosterHandle handle,
                                       const DatasetHandle valid_data) {
  return to_status(call("booster_add_valid_data", "(OO)", none_or(handle),
                        none_or(valid_data)));
}

DllExport int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                            const DatasetHandle train_data) {
  return to_status(call("booster_reset_training_data", "(OO)",
                        none_or(handle), none_or(train_data)));
}

DllExport int LGBM_BoosterResetParameter(BoosterHandle handle,
                                         const char* parameters) {
  return to_status(call("booster_reset_parameter", "(Os)", none_or(handle),
                        parameters));
}

DllExport int LGBM_BoosterGetNumClasses(BoosterHandle handle,
                                        int64_t* out_len) {
  return to_int(call("booster_get_num_classes", "(O)", none_or(handle)),
                out_len);
}

DllExport int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                        int* is_finished) {
  return to_status(call("booster_update_one_iter", "(OK)", none_or(handle),
                        (unsigned long long)is_finished));
}

DllExport int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                              const float* grad,
                                              const float* hess,
                                              int* is_finished) {
  return to_status(call("booster_update_one_iter_custom", "(OKKK)",
                        none_or(handle), (unsigned long long)grad,
                        (unsigned long long)hess,
                        (unsigned long long)is_finished));
}

DllExport int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  return to_status(call("booster_rollback_one_iter", "(O)", none_or(handle)));
}

DllExport int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                              int64_t* out_iteration) {
  return to_int(call("booster_get_current_iteration", "(O)", none_or(handle)),
                out_iteration);
}

DllExport int LGBM_BoosterGetEvalCounts(BoosterHandle handle,
                                        int64_t* out_len) {
  return to_int(call("booster_get_eval_counts", "(O)", none_or(handle)),
                out_len);
}

DllExport int LGBM_BoosterGetEvalNames(BoosterHandle handle, int64_t* out_len,
                                       char** out_strs) {
  return to_int(call("booster_get_eval_names", "(OK)", none_or(handle),
                     (unsigned long long)out_strs),
                out_len);
}

DllExport int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                  int64_t* out_len, float* out_results) {
  return to_int(call("booster_get_eval", "(OiK)", none_or(handle), data_idx,
                     (unsigned long long)out_results),
                out_len);
}

DllExport int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                     int64_t* out_len, float* out_result) {
  return to_int(call("booster_get_predict", "(OiK)", none_or(handle),
                     data_idx, (unsigned long long)out_result),
                out_len);
}

DllExport int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                         const char* data_filename,
                                         int data_has_header,
                                         int predict_type,
                                         int64_t num_iteration,
                                         const char* result_filename) {
  return to_status(call("booster_predict_for_file", "(OsiiLs)",
                        none_or(handle), data_filename, data_has_header,
                        predict_type, (long long)num_iteration,
                        result_filename));
}

DllExport int LGBM_BoosterPredictForCSR(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t nindptr,
    int64_t nelem, int64_t num_col, int predict_type, int64_t num_iteration,
    int64_t* out_len, double* out_result) {
  return to_status(call(
      "booster_predict_for_csr", "(OKiKKiLLLiLKK)", none_or(handle),
      (unsigned long long)indptr, indptr_type, (unsigned long long)indices,
      (unsigned long long)data, data_type, (long long)nindptr,
      (long long)nelem, (long long)num_col, predict_type,
      (long long)num_iteration, (unsigned long long)out_len,
      (unsigned long long)out_result));
}

DllExport int LGBM_BoosterPredictForMat(BoosterHandle handle,
                                        const void* data, int data_type,
                                        int32_t nrow, int32_t ncol,
                                        int is_row_major, int predict_type,
                                        int64_t num_iteration,
                                        int64_t* out_len, double* out_result) {
  return to_status(call("booster_predict_for_mat", "(OKiiiiiLKK)",
                        none_or(handle), (unsigned long long)data, data_type,
                        (int)nrow, (int)ncol, is_row_major, predict_type,
                        (long long)num_iteration,
                        (unsigned long long)out_len,
                        (unsigned long long)out_result));
}

DllExport int LGBM_BoosterSaveModel(BoosterHandle handle, int num_iteration,
                                    const char* filename) {
  return to_status(call("booster_save_model", "(Ois)", none_or(handle),
                        num_iteration, filename));
}

DllExport int LGBM_BoosterDumpModel(BoosterHandle handle, int buffer_len,
                                    int64_t* out_len, char** out_str) {
  return to_status(call("booster_dump_model", "(OiKK)", none_or(handle),
                        buffer_len, (unsigned long long)out_len,
                        (unsigned long long)(out_str ? *out_str : nullptr)));
}

DllExport int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                       int leaf_idx, float* out_val) {
  return to_status(call("booster_get_leaf_value", "(OiiK)", none_or(handle),
                        tree_idx, leaf_idx, (unsigned long long)out_val));
}

DllExport int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                       int leaf_idx, float val) {
  return to_status(call("booster_set_leaf_value", "(Oiif)", none_or(handle),
                        tree_idx, leaf_idx, (double)val));
}
