// Decode without Python: a C runner for AOTInductor packages.
//
// The port's counterpart of native/pjrt_client.cpp. Where the JAX
// package hands a VHLO program to a PJRT plugin, the port hands a
// ``.pt2`` package (torch.export + AOTInductor, made by
// native_rt/aoti.py) to libtorch's AOTIModelPackageLoader, which loads
// the compiled model with its weights. Tensors stay on the device
// between calls: a decode loop passes each step's new cache buffers
// straight into the next step.
//
// C ABI (ctypes-friendly, the dl4j_pjrt_* conventions): functions return
// a handle, a count or 0 on success and NULL or a negative value on
// failure, with the error text copied into the caller's buffer. A
// client must not be shared across threads without external locking.
//
// Built at first use by native_rt/aoti.py (build_runner) with g++
// against the libtorch of the installed torch wheel, with an rpath to
// its lib directory, so the library loads in a process that never
// imports torch.

#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <ATen/ATen.h>
#include <c10/core/InferenceMode.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Client {
  at::Device device{at::kCPU};
};

struct Program {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
};

struct Buffer {
  at::Tensor t;
};

void set_err(char* err, int errn, const std::string& msg) {
  if (err && errn > 0) {
    std::snprintf(err, size_t(errn), "%s", msg.c_str());
  }
}

// dtype codes shared with native_rt/aoti.py (DTYPE_CODES)
bool scalar_of(int code, at::ScalarType* out) {
  static const at::ScalarType table[] = {
      at::kFloat, at::kDouble, at::kHalf, at::kBFloat16, at::kInt,
      at::kLong,  at::kChar,   at::kByte, at::kBool};
  if (code < 0 || code >= int(sizeof(table) / sizeof(table[0]))) {
    return false;
  }
  *out = table[code];
  return true;
}

int code_of(at::ScalarType s) {
  switch (s) {
    case at::kFloat: return 0;
    case at::kDouble: return 1;
    case at::kHalf: return 2;
    case at::kBFloat16: return 3;
    case at::kInt: return 4;
    case at::kLong: return 5;
    case at::kChar: return 6;
    case at::kByte: return 7;
    case at::kBool: return 8;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// A client on ``platform`` ("cuda" or "cpu") at ``device_index``. NULL
// when the platform is absent.
void* dl4j_aoti_open(const char* platform, int device_index, char* err,
                     int errn) {
  try {
    std::string p(platform ? platform : "");
    auto* c = new Client();
    if (p == "cuda") {
      if (!torch::cuda::is_available()) {
        delete c;
        set_err(err, errn, "cuda: no CUDA device is available");
        return nullptr;
      }
      if (device_index < 0 || device_index >= torch::cuda::device_count()) {
        delete c;
        set_err(err, errn, "cuda: device index out of range");
        return nullptr;
      }
      c->device = at::Device(at::kCUDA, c10::DeviceIndex(device_index));
    } else if (p != "cpu") {
      delete c;
      set_err(err, errn, "unknown platform '" + p + "' (cuda or cpu)");
      return nullptr;
    }
    return c;
  } catch (const std::exception& e) {
    set_err(err, errn, e.what());
    return nullptr;
  }
}

void dl4j_aoti_close(void* client) { delete static_cast<Client*>(client); }

// Devices of the client's platform (1 for the CPU).
int dl4j_aoti_device_count(void* client) {
  auto* c = static_cast<Client*>(client);
  if (c->device.is_cuda()) return int(torch::cuda::device_count());
  return 1;
}

// The platform's name into ``out``; returns its length.
int dl4j_aoti_platform(void* client, char* out, int n) {
  auto* c = static_cast<Client*>(client);
  const char* name = c->device.is_cuda() ? "cuda" : "cpu";
  set_err(out, n, name);
  return int(std::strlen(name));
}

// Load a ``.pt2`` package compiled for the client's device. NULL on
// failure (a missing file, a package for another device).
void* dl4j_aoti_load(void* client, const char* package_path,
                     const char* model_name, char* err, int errn) {
  auto* c = static_cast<Client*>(client);
  try {
    auto* p = new Program();
    p->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        std::string(package_path),
        std::string(model_name && *model_name ? model_name : "model"),
        /*run_single_threaded=*/false, /*num_runners=*/1,
        c->device.is_cuda() ? c->device.index() : c10::DeviceIndex(-1));
    return p;
  } catch (const std::exception& e) {
    set_err(err, errn, e.what());
    return nullptr;
  }
}

void dl4j_aoti_program_destroy(void* client, void* program) {
  (void)client;
  delete static_cast<Program*>(program);
}

// Copy a contiguous host array of ``dtype`` (a DTYPE_CODES code) and
// shape ``dims`` onto the client's device. NULL on failure.
void* dl4j_aoti_buffer_from_host(void* client, const void* data, int dtype,
                                 const int64_t* dims, int ndim, char* err,
                                 int errn) {
  auto* c = static_cast<Client*>(client);
  at::ScalarType s;
  if (!scalar_of(dtype, &s)) {
    set_err(err, errn, "unknown dtype code " + std::to_string(dtype));
    return nullptr;
  }
  try {
    std::vector<int64_t> shape(dims, dims + ndim);
    auto host = at::from_blob(const_cast<void*>(data), shape,
                              at::TensorOptions().dtype(s));
    auto* b = new Buffer();
    b->t = host.to(c->device, /*non_blocking=*/false, /*copy=*/true);
    return b;
  } catch (const std::exception& e) {
    set_err(err, errn, e.what());
    return nullptr;
  }
}

void dl4j_aoti_buffer_destroy(void* client, void* buf) {
  (void)client;
  delete static_cast<Buffer*>(buf);
}

// A buffer's dtype code and shape (up to ``max_ndim`` dims); returns its
// rank.
int dl4j_aoti_buffer_shape(void* client, void* buf, int* dtype,
                           int64_t* dims, int max_ndim) {
  (void)client;
  const at::Tensor& t = static_cast<Buffer*>(buf)->t;
  *dtype = code_of(t.scalar_type());
  int nd = int(t.dim());
  for (int i = 0; i < nd && i < max_ndim; ++i) dims[i] = t.size(i);
  return nd;
}

// Copy a buffer to host memory of ``capacity`` bytes (row-major);
// returns the bytes written, or -1.
int64_t dl4j_aoti_buffer_to_host(void* client, void* buf, void* out,
                                 int64_t capacity, char* err, int errn) {
  (void)client;
  try {
    at::Tensor host = static_cast<Buffer*>(buf)->t.to(at::kCPU).contiguous();
    int64_t nbytes = int64_t(host.nbytes());
    if (nbytes > capacity) {
      set_err(err, errn,
              "buffer of " + std::to_string(nbytes) +
                  " bytes exceeds the host capacity of " +
                  std::to_string(capacity));
      return -1;
    }
    std::memcpy(out, host.data_ptr(), size_t(nbytes));
    return nbytes;
  } catch (const std::exception& e) {
    set_err(err, errn, e.what());
    return -1;
  }
}

// Run a program on ``n_in`` device buffers; its outputs become new
// buffers in ``out_bufs``. Returns the output count, or -1.
int64_t dl4j_aoti_execute(void* client, void* program, void** in_bufs,
                          int n_in, void** out_bufs, int max_out, char* err,
                          int errn) {
  (void)client;
  auto* p = static_cast<Program*>(program);
  try {
    c10::InferenceMode guard;
    std::vector<at::Tensor> inputs;
    inputs.reserve(size_t(n_in));
    // a compiled program reads its inputs at the strides it was traced
    // with (dense): a strided buffer is made dense first
    for (int i = 0; i < n_in; ++i) {
      inputs.push_back(static_cast<Buffer*>(in_bufs[i])->t.contiguous());
    }
    std::vector<at::Tensor> outs = p->loader->run(inputs);
    if (int(outs.size()) > max_out) {
      set_err(err, errn,
              "program returned " + std::to_string(outs.size()) +
                  " outputs; room for " + std::to_string(max_out));
      return -1;
    }
    for (size_t i = 0; i < outs.size(); ++i) {
      auto* b = new Buffer();
      b->t = std::move(outs[i]);
      out_bufs[i] = b;
    }
    return int64_t(outs.size());
  } catch (const std::exception& e) {
    set_err(err, errn, e.what());
    return -1;
  }
}

}  // extern "C"
