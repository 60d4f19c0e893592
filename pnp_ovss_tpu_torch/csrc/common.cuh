// Shared helpers for the port's CUDA kernels (sm_90a).
//
// Every kernel library exposes plain C entry points that launch on the
// caller's stream and return cudaGetLastError(); pnp_error_string turns
// that code into a message for the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* pnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace pnp {

// Two floats -> one register of two bf16 (round to nearest even); the
// lower-index element sits in the low half, as wgmma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t r) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

}  // namespace pnp
