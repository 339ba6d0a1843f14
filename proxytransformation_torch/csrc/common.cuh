// Shared by every kernel library in this directory: each .cu builds into
// its own shared library with a plain C interface, loaded with ctypes.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Text of the cudaError_t code that an entry point returned.
extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
