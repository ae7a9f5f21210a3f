// Helpers shared by the kernels of repro_torch: element conversion to and
// from the f32 that every kernel computes in, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// The dtype codes the Python wrappers pass (kernels/_build.py DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

// Finite "minus infinity" of the Pallas kernels: exp(NEG_INF - m) is 0 for
// any finite m, and a fully masked row never produces inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rt

// Every library of repro_torch exports this, so the wrappers can name the
// error that a launch function returned.
extern "C" const char* rt_error_string(int code);

#define RT_DEFINE_ERROR_STRING                                  \
  extern "C" const char* rt_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
