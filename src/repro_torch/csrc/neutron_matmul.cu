// Output-stationary fused matmul: the Neutron dot-product engine (K1).
//
// Replaces the Pallas kernel `_matmul_kernel` / `neutron_matmul` of
// src/repro/kernels/neutron_matmul.py (pl.pallas_call at line 137).
//
// One GEMM body, y[b, m, n] = epilogue(sum_k x[b, m, k] * w[n, k]), with
// two epilogues:
//
//   Pallas contract (the TPU kernel's, _matmul_kernel lines 54-66):
//     v = f32(acc) [* scale[n] or * scale] [+ bias_f32[n]]; v = act(v);
//     then either y = v (f32 or bf16) or, with requant,
//     y = int8(clip(rint(v / out_scale), -128, 127)).
//     int8 inputs accumulate in int32, f32/bf16 inputs in f32.
//
//   Plan contract (the int8 plan replay, quant/execplan.py lines 177-179
//   followed by quantize, quant/qparams.py lines 57-61):
//     v = f32(acc + bias_i32[n]) * sc[n]; v = act(v);
//     y = int8(clip(rint(v / out_scale) + out_zp, qmin, qmax)).
//     The input zero point is folded into bias_i32 by the caller, and the
//     int32 bias is added before the rescale.  int8 inputs only.
//
// The activations are those of core/ir.py:_apply_act (lines 598-624), in
// the same float32 operation order; the Pallas contract's set is a subset
// of it (equal within float32 tolerance to jax.nn's forms).  Every rounding
// of the epilogue is explicit (__fmul_rn, __fadd_rn, __fdiv_rn, rintf) so
// that nvcc's default FMA contraction cannot merge two roundings into one,
// the division is correctly rounded as numpy's is, and rounding is half to
// even as np.round's.  Piecewise-linear activations (none, relu, relu6,
// hswish, hsigmoid, leaky) are therefore bit-exact with the numpy
// reference; exp/tanh ones may differ by an ulp before requantization.
// gelu's tanh term is taken in double, where numpy takes it (its sqrt(2/pi)
// is a float64 scalar).
//
// Addressing: row m of image b of x starts at
//   x + b * x_bstride + (m / x_ow) * x_sy + (m % x_ow) * x_sx
// and holds K contiguous elements; w is (N, K) row-major (the natural
// layout of an (outC, fh, fw, inC) conv weight); y[b, m, n] lies at
// y + b * y_bstride + m * ldy + n.  So a 1x1 conv of stride s reads its
// arena slot in place (x_ow = OW, x_sy = s * W * C, x_sx = s * C) and
// every conv writes its output slot in place across the n requests of the
// arena (y_bstride = the arena's row pitch).
//
// What bounds it on an H100: at the vision plan's shapes the GEMMs do
// 2 * M * N * K int8 operations on a few MB (tensor-core int8 bound
// 1979 TOP/s; device memory 3.35 TB/s); the larger resnet50 products are
// operation-bound, the 1x1 convs of mobilenet_v2 byte-bound.  This first
// version is neither: it is a plain tiled kernel whose products run on
// __dp4a (4 int8 MACs per instruction on the CUDA cores, not the tensor
// cores) from shared memory, with byte-wise staging loads.
//
// Design: one block of 256 threads per 64 x 64 output tile of one image,
// grid (ceil(N/64), ceil(M/64), batch).  Each k-tile of 32 stages 64 rows
// of x and 64 rows of w in shared memory; K is padded with zeros to the
// tile (so K = 27 or 147 need no special case), int8 as 4-byte words for
// __dp4a, floats as f32.  Each thread owns a 4 x 4 register tile of
// outputs at rows ty + 16 i and columns tx + 16 j (i, j < 4), which keeps
// its shared-memory reads free of bank conflicts, and runs the epilogue on
// it before the one write of the result.  wgmma, TMA and vector loads are
// later work.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;               // k per staged tile
constexpr int kWords = kBK / 4;       // int8 words per staged row
constexpr int kThreads = 256;
constexpr int kSide = 16;             // threads form a 16 x 16 grid
constexpr int kReg = kBM / kSide;     // 4 x 4 outputs per thread

enum InOut : int { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Contract : int { kPallas = 0, kPlan = 1 };
// core/ir.py ACTIVATIONS order
enum Act : int {
  kNone = 0, kRelu, kRelu6, kHswish, kHsigmoid, kSilu, kSigmoid, kGelu,
  kMish, kSqrelu, kLeaky
};

struct Params {
  const void* x;
  const void* w;
  const float* scale;
  const void* bias;
  void* y;
  int M, N, K;
  long long x_bstride, x_sy, x_sx;
  int x_ow;
  long long y_bstride;
  int ldy;
  int contract, act, scale_per_col, requant, out_dtype;
  float out_scale;
  int out_zp, qmin, qmax;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// core/ir.py:_apply_act, operation for operation in float32.
__device__ float activation(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kRelu6:
      return clampf(x, 0.f, 6.f);
    case kHswish:  // x * clip(x + 3, 0, 6) / 6
      return __fdiv_rn(__fmul_rn(x, clampf(__fadd_rn(x, 3.f), 0.f, 6.f)),
                       6.f);
    case kHsigmoid:  // clip(x + 3, 0, 6) / 6
      return __fdiv_rn(clampf(__fadd_rn(x, 3.f), 0.f, 6.f), 6.f);
    case kSilu:  // x / (1 + exp(-clip(x, -30, 30)))
      return __fdiv_rn(x, __fadd_rn(1.f, expf(-clampf(x, -30.f, 30.f))));
    case kSigmoid:  // 1 / (1 + exp(-clip(x, -30, 30)))
      return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-clampf(x, -30.f, 30.f))));
    case kGelu: {  // 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
      const float inner =
          __fadd_rn(x, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(x, x), x)));
      const double t = tanh(0.7978845608028654 * static_cast<double>(inner));
      return static_cast<float>(0.5 * static_cast<double>(x) * (1.0 + t));
    }
    case kMish: {  // x * tanh(log1p(exp(-|x|)) + max(x, 0))
      const float sp = __fadd_rn(log1pf(expf(-fabsf(x))), fmaxf(x, 0.f));
      return __fmul_rn(x, tanhf(sp));
    }
    case kSqrelu: {
      const float r = fmaxf(x, 0.f);
      return __fmul_rn(r, r);
    }
    case kLeaky:  // where(x > 0, x, 0.1 x)
      return x > 0.f ? x : __fmul_rn(0.1f, x);
    default:
      return x;
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One k-tile of int8 x and w, as 4-byte words, zero past K and past the
// last row.  Thread t stages words (t / 8 + 32 r, t % 8), r = 0, 1, of
// both tiles, from row pointers it computed once.
__device__ __forceinline__ int pack4(const int8_t* row, int k, int K) {
  int word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = (k + j < K) ? static_cast<int>(row[k + j]) : 0;
    word |= (v & 0xff) << (8 * j);
  }
  return word;
}

// Row m of image b of x (strides in elements).
template <typename T>
__device__ __forceinline__ const T* x_row(const Params& p, int b, int m) {
  return static_cast<const T*>(p.x) +
         (static_cast<long long>(b) * p.x_bstride +
          static_cast<long long>(m / p.x_ow) * p.x_sy +
          static_cast<long long>(m % p.x_ow) * p.x_sx);
}

// The GEMM body for int8 operands: int32 accumulators via __dp4a.
__device__ void gemm_i8(const Params& p, int b, int m0, int n0,
                        int (&acc)[kReg][kReg]) {
  __shared__ int xs[kBM][kWords + 1];
  __shared__ int ws[kBN][kWords + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int lr = tid / kWords, lc = tid % kWords;  // staging position
  const int8_t* xr[2];
  const int8_t* wr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + lr + 32 * r, n = n0 + lr + 32 * r;
    xr[r] = m < p.M ? x_row<int8_t>(p, b, m) : nullptr;
    wr[r] = n < p.N ? static_cast<const int8_t*>(p.w) +
                          static_cast<long long>(n) * p.K
                    : nullptr;
  }
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    const int k = k0 + 4 * lc;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[lr + 32 * r][lc] = xr[r] ? pack4(xr[r], k, p.K) : 0;
      ws[lr + 32 * r][lc] = wr[r] ? pack4(wr[r], k, p.K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      int a[kReg], w[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) a[i] = xs[ty + kSide * i][c];
#pragma unroll
      for (int j = 0; j < kReg; ++j) w[j] = ws[tx + kSide * j][c];
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The GEMM body for f32 / bf16 operands: f32 accumulators.  Thread t
// stages elements (t / 32 + 8 r, t % 32), r < 8, of both tiles.
template <typename T>
__device__ void gemm_f(const Params& p, int b, int m0, int n0,
                       float (&acc)[kReg][kReg]) {
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[kBN][kBK + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int lr = tid / kBK, lc = tid % kBK;
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    const int k = k0 + lc;
#pragma unroll
    for (int r = 0; r < kBM / (kThreads / kBK); ++r) {
      const int row = lr + (kThreads / kBK) * r;
      const int m = m0 + row, n = n0 + row;
      xs[row][lc] = (m < p.M && k < p.K)
                        ? load_f32(x_row<T>(p, b, m) + k)
                        : 0.f;
      ws[row][lc] = (n < p.N && k < p.K)
                        ? load_f32(static_cast<const T*>(p.w) +
                                   static_cast<long long>(n) * p.K + k)
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float a[kReg], w[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) a[i] = xs[ty + kSide * i][c];
#pragma unroll
      for (int j = 0; j < kReg; ++j) w[j] = ws[tx + kSide * j][c];
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store(const Params& p, int b, int m, int n,
                                      float v) {
  const long long idx = static_cast<long long>(b) * p.y_bstride +
                        static_cast<long long>(m) * p.ldy + n;
  switch (p.out_dtype) {
    case kI8:
      static_cast<int8_t*>(p.y)[idx] = static_cast<int8_t>(static_cast<int>(v));
      break;
    case kBF16:
      static_cast<__nv_bfloat16*>(p.y)[idx] = __float2bfloat16(v);
      break;
    default:
      static_cast<float*>(p.y)[idx] = v;
  }
}

// The epilogue of one output, from its accumulator (int32 as int, f32).
__device__ __forceinline__ float epilogue_plan(const Params& p, int n,
                                               int acc) {
  const int bias = p.bias ? static_cast<const int*>(p.bias)[n] : 0;
  float v = __int2float_rn(acc + bias);
  v = __fmul_rn(v, p.scale[p.scale_per_col ? n : 0]);
  v = activation(v, p.act);
  float q = rintf(__fdiv_rn(v, p.out_scale));
  q = __fadd_rn(q, static_cast<float>(p.out_zp));
  return clampf(q, static_cast<float>(p.qmin), static_cast<float>(p.qmax));
}

__device__ __forceinline__ float epilogue_pallas(const Params& p, int n,
                                                 float v) {
  if (p.scale) v = __fmul_rn(v, p.scale[p.scale_per_col ? n : 0]);
  if (p.bias) v = __fadd_rn(v, static_cast<const float*>(p.bias)[n]);
  v = activation(v, p.act);
  if (p.requant) v = clampf(rintf(__fdiv_rn(v, p.out_scale)), -128.f, 127.f);
  return v;
}

__global__ void __launch_bounds__(kThreads)
neutron_matmul_i8(const Params p) {
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  int acc[kReg][kReg] = {};
  gemm_i8(p, b, m0, n0, acc);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int m = m0 + ty + kSide * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n >= p.N) continue;
      const float v = p.contract == kPlan
                          ? epilogue_plan(p, n, acc[i][j])
                          : epilogue_pallas(p, n, __int2float_rn(acc[i][j]));
      store(p, b, m, n, v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
neutron_matmul_f(const Params p) {
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  float acc[kReg][kReg] = {};
  gemm_f<T>(p, b, m0, n0, acc);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int m = m0 + ty + kSide * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n >= p.N) continue;
      store(p, b, m, n, epilogue_pallas(p, n, acc[i][j]));
    }
  }
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes, devices and the int32 range of the accumulators.
extern "C" int neutron_matmul_launch(
    const void* x, const void* w, const void* scale, const void* bias,
    void* y, int batch, int M, int N, int K, long long x_bstride, int x_ow,
    long long x_sy, long long x_sx, long long y_bstride, int ldy,
    int in_dtype, int out_dtype, int contract, int act, int scale_per_col,
    int requant, float out_scale, int out_zp, int qmin, int qmax,
    void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || x_ow < 1 ||
      (M + kBM - 1) / kBM > 65535 || batch > 65535 || act < kNone ||
      act > kLeaky || (contract == kPlan && (in_dtype != kI8 || !scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, static_cast<const float*>(scale), bias, y, M, N, K,
           x_bstride, x_sy, x_sx, x_ow, y_bstride, ldy, contract, act,
           scale_per_col, requant, out_dtype, out_scale, out_zp, qmin, qmax};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kI8:
      neutron_matmul_i8<<<grid, kThreads, 0, st>>>(p);
      break;
    case kF32:
      neutron_matmul_f<float><<<grid, kThreads, 0, st>>>(p);
      break;
    case kBF16:
      neutron_matmul_f<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
