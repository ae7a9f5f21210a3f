// Helpers shared by the kernels of repro_torch: element conversion to and
// from the f32 that every kernel computes in, warp reductions, and the
// asynchronous copies, `ldmatrix` loads and `mma.sync` products of the
// tensor-core bodies (K1 int8 and 3xTF32, K2, K2b, K4 and K4b bf16).
#pragma once

#include <cstdint>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W bytes (4, 8 or 16) from global to shared memory, asynchronously; with
// ok false they are zero-filled and nothing is read (src must still be a
// valid address).
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  static_assert(W == 4 || W == 8 || W == 16, "cp.async copies 4, 8 or 16");
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(W), "r"(ok ? W : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four (two) 8x8 matrices of 16-bit elements (or 8x16 bytes); lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) x columns [0, cols) of a bf16 matrix (row stride ld_src)
// into shared memory at pitch ld, zero up to prows x pcols, by the whole
// block; 16-byte asynchronous copies where `vec` (cols % 8 == 0, 16-byte
// aligned rows), else element by element.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int rows, int cols,
                                           size_t ld_src, int prows,
                                           int pcols, int ld, bool vec) {
  const int cpr = pcols / 8;
  for (int i = threadIdx.x; i < prows * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 8;
    __nv_bfloat16* d = dst + r * ld + c;
    if (vec) {
      const bool ok = r < rows && c < cols;
      cp_async<16>(d, ok ? src + r * ld_src + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (r < rows && c + j < cols) ? src[r * ld_src + c + j]
                                          : __float2bfloat16(0.f);
    }
  }
}

// c += a (16 x 8, row) * b (8 x 8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as the two halves of a 3xTF32 operand: hi = v with its low 13
// mantissa bits cleared (a tf32 value), lo = v - hi (exact in f32; the
// tensor core reads its top 19 bits, so lo is taken to tf32 by
// truncation, an error below 2^-20 |v|).
__device__ __forceinline__ void tf32_hi_lo(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

}  // namespace rt

// Every library of repro_torch exports this, so the wrappers can name the
// error that a launch function returned.
extern "C" const char* rt_error_string(int code);

#define RT_DEFINE_ERROR_STRING                                  \
  extern "C" const char* rt_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
