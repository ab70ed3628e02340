// Includes and the one entry point every kernel library exports: the text of
// a CUDA error code, which kernels/_build.py reads when a launch fails.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* physicedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
