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
// Rows across images: the int8 body indexes output rows r over batch * M,
// (b, m) = divmod(r, M), so one tile may span images (the fc's M = 1 rows
// of a batch of 8 are one 8-row product).
//
// What bounds it on an H100: at the vision plan's shapes every GEMM moves
// more bytes than the int8 tensor cores need time for (1979 TOP/s dense
// against 3.35 TB/s: 590 operations a byte), so device memory bounds it in
// principle.  Measured, what bounds it is latency: each block's chain of
// loads, barriers and epilogue (the fp32 rescale, activation and correctly
// rounded division of every output), with too few blocks an SM to hide
// it, and at the small shapes a floor of a few microseconds a launch.
//
// Design of the int8 body (`neutron_matmul_i8`, both contracts):
//   * Products on the tensor cores: `mma.sync.m16n8k32` s8 x s8 -> s32 on
//     `ldmatrix` fragments.  x (rows, K) and w (N, K) are both K-major,
//     so neither needs a transpose.  A block of 4 warps owns a 64 x 64
//     output tile, each warp 32 x 32 (2 x 4 mma tiles).
//   * Staging: a 4-stage `cp.async` ring of k-tiles of 64 bytes in shared
//     memory, rows padded to 80 bytes (conflict-free `ldmatrix`), K zero-
//     filled to the tile in shared memory.  The load width (16, 8 or 4
//     bytes, `cp.async` with its zero-fill form; 1: plain byte loads) is
//     chosen per call by the wrapper from the alignment of K, of the row,
//     image and batch strides and of both base pointers
//     (kernels/neutron_matmul.py plan): mobilenet_v2's strided 1x1 convs
//     over C = 24 read rows 48 bytes apart with 8-byte copies.
//   * Span mode, for rows that are contiguous (the im2col buffers, x_sx =
//     K) with K <= 160 not a multiple of 16 (the stems, K = 27 and 147): a
//     tile's rows of x, and of w, are each one contiguous span, both read
//     with 16-byte copies before one wait and laid out again in shared
//     memory at a pitch of K rounded up to 32, plus 16, zero-filled; the
//     whole K is one tile.  Where those tiles are small (K <= 64), the
//     instance asks for 8 blocks an SM.
//   * Split-K where the tile grid leaves SMs idle (the fc, the M = 49
//     convs): blocks of one tile add their int32 partials with atomics into
//     an int32 scratch (integer sums are exact, so the bits do not depend
//     on the order); the last block of the tile, found by an atomic ticket
//     after a fence, reads the sums, resets scratch and ticket to 0 and
//     runs the epilogue.  The wrapper picks the split (a pure function).
//   * Epilogue: the accumulators go through shared memory, and each thread
//     takes four consecutive columns of a row, with the tile's column
//     scales and biases read once into shared memory; int8 outputs are
//     stored as 4-byte words.  The arithmetic is the first version's,
//     operation for operation (a zero dividend skips the division, whose
//     result it knows: 0); the loop is instantiated per activation and
//     contract, so its body holds one activation's code and no switch.
// What is left: overlapping one tile's epilogue with the next tile's loads
// (a persistent block per SM); `wgmma` and TMA pay off only where the
// products bound it (batches far above 8).
//
// The f32 / bf16 bodies (the Pallas contract for float inputs, tests only)
// are the first version's: one block of 256 threads per 64 x 64 output
// tile of one image, grid (ceil(N/64), ceil(M/64), batch), k-tiles of 32
// staged in shared memory as f32, each thread a 4 x 4 register tile of
// scalar FMAs.

#include <cstdint>

#include "common.cuh"

namespace {

// f32 / bf16 bodies
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;               // k per staged tile
constexpr int kThreads = 256;
constexpr int kSide = 16;             // threads form a 16 x 16 grid
constexpr int kReg = kBM / kSide;     // 4 x 4 outputs per thread

// int8 body
constexpr int kI8Threads = 128;       // 4 warps, 2 x 2, each 32 x 32
constexpr int kTM = 64;               // output rows per tile
constexpr int kTN = 64;               // output columns per tile
constexpr int kRingBK = 64;           // bytes of K per ring stage
constexpr int kRingStages = 4;
constexpr int kSpanK = 160;           // span mode: the whole K, <= 160
constexpr int kSpan = 0;              // load mode of span mode
constexpr int kAccLD = kTN + 4;       // pitch of the staged accumulators
constexpr int kSmemPerSM = 227 * 1024;  // shared memory blocks of an SM share

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
  // int8 body: rows over batch * M, the k-split and its scratch
  int R, splits;
  int* scratch;
  int* tickets;
};


__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// core/ir.py:_apply_act, operation for operation in float32.
// Inlined so that a caller passing a constant `act` keeps only its case.
__device__ __forceinline__ float activation(float x, int act) {
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

// Row m of image b of x (strides in elements).
template <typename T>
__device__ __forceinline__ const T* x_row(const Params& p, int b, int m) {
  return static_cast<const T*>(p.x) +
         (static_cast<long long>(b) * p.x_bstride +
          static_cast<long long>(m / p.x_ow) * p.x_sy +
          static_cast<long long>(m % p.x_ow) * p.x_sx);
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

// The epilogue of one output, from its accumulator (int32 as int, f32),
// its column's scale and bias, with activation `act` (p.act, or a constant
// that folds the switch).
__device__ __forceinline__ float epilogue_plan(const Params& p, int bias,
                                               float scale, int acc,
                                               int act) {
  float v = __int2float_rn(acc + bias);
  v = __fmul_rn(v, scale);
  v = activation(v, act);
  // 0 / s is 0; the division's range check would send a zero dividend
  // down its slow path
  float q = v == 0.f ? 0.f : rintf(__fdiv_rn(v, p.out_scale));
  q = __fadd_rn(q, static_cast<float>(p.out_zp));
  return clampf(q, static_cast<float>(p.qmin), static_cast<float>(p.qmax));
}

__device__ __forceinline__ float epilogue_pallas(const Params& p,
                                                 float scale, float bias,
                                                 float v, int act) {
  if (p.scale) v = __fmul_rn(v, scale);
  if (p.bias) v = __fadd_rn(v, bias);
  v = activation(v, act);
  if (p.requant && v != 0.f)
    v = clampf(rintf(__fdiv_rn(v, p.out_scale)), -128.f, 127.f);
  return v;
}

// Column n's scale and bias (the bias as its 32 bits: int32 in the plan
// contract, f32 in the Pallas one); 1 and 0 where there is none.
__device__ __forceinline__ float col_scale(const Params& p, int n) {
  return p.scale ? p.scale[p.scale_per_col ? n : 0] : 1.f;
}
__device__ __forceinline__ int col_bias(const Params& p, int n) {
  return p.bias ? static_cast<const int*>(p.bias)[n] : 0;
}

// --------------------------------------------------------------------------
// int8: mma.sync m16n8k32 on the tensor cores
// --------------------------------------------------------------------------

using rt::cp_async;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldmatrix_x4;

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_i8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of row r (over batch * M) of x.
__device__ __forceinline__ long long x_offset(const Params& p, int r) {
  const int b = r / p.M;
  const int m = r - b * p.M;
  return static_cast<long long>(b) * p.x_bstride +
         static_cast<long long>(m / p.x_ow) * p.x_sy +
         static_cast<long long>(m % p.x_ow) * p.x_sx;
}

// Shared-memory layout of one stage: x tile (kTM rows) then w tile (kTN
// rows), each row BK bytes at a pitch of BK + 16.
template <int BK>
struct I8Tile {
  static constexpr int LD = BK + 16;
  static constexpr int kStage = (kTM + kTN) * LD;
};

// The ring's staging geometry for load width W (1 stages 4-byte words
// from byte loads): a thread stages NR rows of each operand, RSTEP rows
// apart, at the same column chunk.
template <int W>
struct Ring {
  static constexpr int CW = W < 4 ? 4 : W;
  static constexpr int CPR = kRingBK / CW;
  static constexpr int RSTEP = kI8Threads / CPR;
  static constexpr int NR = kTM / RSTEP;
};

// Stage k-tile kt of both operands into `stage`: row pointers are null
// past the last row, chunks past K are zero (`any` is a valid address
// that a zero-filled copy names and does not read).
template <int W>
__device__ __forceinline__ void ring_load(
    int8_t* stage, const int8_t* const (&xr)[Ring<W>::NR],
    const int8_t* const (&wr)[Ring<W>::NR], const int8_t* any, int kt,
    int K) {
  using G = Ring<W>;
  constexpr int LD = I8Tile<kRingBK>::LD;
  const int cc = threadIdx.x % G::CPR;
  const int rr = threadIdx.x / G::CPR;
  const int k = kt * kRingBK + cc * G::CW;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    int8_t* dst0 = stage + (op ? kTM * LD : 0) + rr * LD + cc * G::CW;
#pragma unroll
    for (int i = 0; i < G::NR; ++i) {
      const int8_t* src = op ? wr[i] : xr[i];
      int8_t* dst = dst0 + i * G::RSTEP * LD;
      if constexpr (W >= 4) {
        const bool ok = src != nullptr && k < K;
        cp_async<W>(dst, ok ? src + k : any, ok);
      } else {
        uint32_t word = 0;
        if (src != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < K)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(src[k + j]))
                      << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(dst) = word;
      }
    }
  }
}

// Span mode: rows [row0, row0 + nrows) of a row-contiguous operand (row r
// at base + r * K, nrows >= 1) are copied as one 16-byte aligned span
// into `tmp`; returns the offset of row0 in it.
__device__ __forceinline__ int span_issue(uint8_t* tmp, const int8_t* base,
                                          int row0, int nrows, int K) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(base) +
                          static_cast<uintptr_t>(row0) * K;
  const uintptr_t a0 = start & ~static_cast<uintptr_t>(15);
  const uintptr_t end = start + static_cast<uintptr_t>(nrows) * K;
  const int chunks = static_cast<int>((end - a0 + 15) / 16);
  for (int i = threadIdx.x; i < chunks; i += kI8Threads)
    cp_async<16>(tmp + 16 * i, reinterpret_cast<const void*>(a0 + 16 * i),
                 true);
  return static_cast<int>(start - a0);
}

// ... then laid out again into `dst` at pitch ld, zero past K (up to kp,
// K rounded up to 32) and past nrows.
__device__ __forceinline__ void span_repack(int8_t* dst, const uint8_t* tmp,
                                            int off, int nrows, int K, int kp,
                                            int ld) {
  const int wpr = kp / 4;  // 4-byte words per staged row
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tmp);
  // word i = threadIdx.x + j * kI8Threads lies at (row, k / 4); both step
  // by a constant, so there is no division in the loop
  const int drow = kI8Threads / wpr, dword = kI8Threads % wpr;
  int row = threadIdx.x / wpr, kw = threadIdx.x % wpr;
  for (; row < kTM; row += drow, kw += dword) {
    if (kw >= wpr) {
      kw -= wpr;
      if (++row >= kTM) break;
    }
    const int k = 4 * kw;
    uint32_t word = 0;
    if (row < nrows && k < K) {
      const int s = off + row * K + k;
      word = __byte_perm(t32[s >> 2], t32[(s >> 2) + 1],
                         0x3210 + 0x1111 * (s & 3));
      if (K - k < 4) word &= (1u << (8 * (K - k))) - 1u;
    }
    *reinterpret_cast<uint32_t*>(dst + row * ld + k) = word;
  }
}

// Span mode's shared memory for K (<= kSpanK): the x and w tiles at pitch
// kp + 16 (kp = K rounded up to 32), then the two staged spans; the
// staged accumulators of the epilogue reuse it from the start.
struct SpanSmem {
  int kp, ld, tmp, bytes;
  __host__ __device__ explicit SpanSmem(int K)
      : kp((K + 31) / 32 * 32), ld(kp + 16), tmp((kTM * K + 47) / 16 * 16),
        bytes(max(2 * kTM * ld + 2 * tmp, kTM * kAccLD * 4)) {}
};

// One k-step of 32 bytes of the warp's 32 x 32 tile from tiles at
// pitch LD: A fragments of two m-tiles, B fragments of four n-tiles.
__device__ __forceinline__ void mma_step(int (&acc)[2][4][4],
                                         const int8_t* xs, const int8_t* ws,
                                         int kb, int LD) {
  const int lane = threadIdx.x & 31;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  uint32_t a[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldmatrix_x4(a[mi], xs + (mi * 16 + lm_row + (lm_mat & 1) * 8) * LD + kb +
                           (lm_mat >> 1) * 16);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4(b, ws + (np * 16 + lm_row + (lm_mat >> 1) * 8) * LD + kb +
                       (lm_mat & 1) * 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_i8(acc[mi][2 * np], a[mi], b[0], b[1]);
      mma_i8(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
    }
  }
}

// The epilogue of a block's tile from its accumulators in shared memory
// (pitch kAccLD) and its columns' scales and biases (staged in shared
// memory at the block's start), four consecutive columns of the tile's
// rows x cols a thread at a time, int8 stored as one 4-byte word where
// aligned.  ACT and the contract are constants, so the loop body holds one
// activation's code and no branch on the contract.
template <int ACT, bool PLAN>
__device__ __forceinline__ void epilogue_tile(const Params& p,
                                              const int* acc_s,
                                              const float* sc_s,
                                              const int* bias_s, int r0,
                                              int n0, int rows, int cols) {
  const bool words = p.out_dtype == kI8 &&
                     ((reinterpret_cast<uintptr_t>(p.y) | p.ldy |
                       static_cast<uintptr_t>(p.y_bstride)) & 3) == 0;
  const int cw = (cols + 3) / 4;  // 4-column groups of the tile's columns
  // group i = threadIdx.x + j * kI8Threads is (lr, lc / 4), stepped as in
  // span_repack
  const int drow = kI8Threads / cw, dgrp = kI8Threads % cw;
  int lr = threadIdx.x / cw, grp = threadIdx.x % cw;
#pragma unroll 1
  for (; lr < rows; lr += drow, grp += dgrp) {
    if (grp >= cw) {
      grp -= cw;
      if (++lr >= rows) break;
    }
    const int lc = 4 * grp;
    const int r = r0 + lr;
    const int b = r / p.M;
    const int m = r - b * p.M;
    const int n = n0 + lc;
    const int nv = min(4, cols - lc);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lc + j;
      const int a = acc_s[lr * kAccLD + c];
      v[j] = PLAN ? epilogue_plan(p, bias_s[c], sc_s[c], a, ACT)
                  : epilogue_pallas(p, sc_s[c], __int_as_float(bias_s[c]),
                                    __int2float_rn(a), ACT);
    }
    if (words) {
      int8_t* dst = static_cast<int8_t*>(p.y) +
                    (static_cast<long long>(b) * p.y_bstride +
                     static_cast<long long>(m) * p.ldy + n);
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    static_cast<int8_t>(static_cast<int>(v[j]))))
                << (8 * j);
      if (nv == 4) {
        *reinterpret_cast<uint32_t*>(dst) = word;
      } else {
        for (int j = 0; j < nv; ++j)
          dst[j] = static_cast<int8_t>(word >> (8 * j));
      }
    } else {
      for (int j = 0; j < nv; ++j) store(p, b, m, n + j, v[j]);
    }
  }
}

// The int8 body.  W: the load width (16, 8, 4, 1), or kSpan.  Grid
// (ceil(R / 64), ceil(N / 64), splits); dynamic shared memory of
// ring_smem_bytes() or SpanSmem(K).bytes.  MINB: the blocks an SM should
// hold, 8 for span mode where its tiles are small enough (K <= 64) that
// shared memory allows 8 (64 registers a thread), else 1 (no bound).
constexpr int ring_smem_bytes() {
  return kRingStages * I8Tile<kRingBK>::kStage;
}
static_assert(ring_smem_bytes() >= kTM * kAccLD * 4, "accumulators fit");

template <int W, int MINB>
__global__ void __launch_bounds__(kI8Threads, MINB)
neutron_matmul_i8(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float sc_s[kTN];
  __shared__ int bias_s[kTN];
  __shared__ int last_block;

  const int r0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 quadrant
  const int g = lane >> 2, t = lane & 3;
  const int8_t* x = static_cast<const int8_t*>(p.x);
  const int8_t* w = static_cast<const int8_t*>(p.w);
  // a warp whose rows or columns all lie past the edge skips its products
  const bool busy = r0 + wm * 32 < p.R && n0 + wn * 32 < p.N;
  // the tile's column scales and biases, read once, beside the main loads
  // (the first barrier below publishes them)
  if (threadIdx.x < kTN) {
    const int n = min(n0 + static_cast<int>(threadIdx.x), p.N - 1);
    sc_s[threadIdx.x] = col_scale(p, n);
    bias_s[threadIdx.x] = col_bias(p, n);
  }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  if constexpr (W == kSpan) {
    const SpanSmem sp(p.K);
    uint8_t* tmp = reinterpret_cast<uint8_t*>(smem + 2 * kTM * sp.ld);
    const int xrows = min(kTM, p.R - r0), wrows = min(kTN, p.N - n0);
    const int xoff = span_issue(tmp, x, r0, xrows, p.K);
    const int woff = span_issue(tmp + sp.tmp, w, n0, wrows, p.K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    span_repack(smem, tmp, xoff, xrows, p.K, sp.kp, sp.ld);
    span_repack(smem + kTM * sp.ld, tmp + sp.tmp, woff, wrows, p.K, sp.kp,
                sp.ld);
    __syncthreads();
    if (busy) {
      const int8_t* xs = smem + wm * 32 * sp.ld;
      const int8_t* ws = smem + kTM * sp.ld + wn * 32 * sp.ld;
      for (int kb = 0; kb < p.K; kb += 32) mma_step(acc, xs, ws, kb, sp.ld);
    }
  } else {
    using G = Ring<W>;
    constexpr int STAGES = kRingStages;
    constexpr int LD = I8Tile<kRingBK>::LD;
    const int kt_all = (p.K + kRingBK - 1) / kRingBK;
    const int kt0 = static_cast<int>(
        static_cast<long long>(blockIdx.z) * kt_all / p.splits);
    const int kt1 = static_cast<int>(
        static_cast<long long>(blockIdx.z + 1) * kt_all / p.splits);
    const int nk = kt1 - kt0;
    const int8_t* xr[G::NR];
    const int8_t* wr[G::NR];
    const int rr = threadIdx.x / G::CPR;
#pragma unroll
    for (int i = 0; i < G::NR; ++i) {
      const int r = r0 + rr + i * G::RSTEP;
      const int n = n0 + rr + i * G::RSTEP;
      xr[i] = r < p.R ? x + x_offset(p, r) : nullptr;
      wr[i] = n < p.N ? w + static_cast<long long>(n) * p.K : nullptr;
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) ring_load<W>(smem + s * I8Tile<kRingBK>::kStage, xr, wr, x,
                               kt0 + s, p.K);
      cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile `it` has landed; tile it - 1 is consumed
      const int nxt = it + STAGES - 1;
      if (nxt < nk)
        ring_load<W>(smem + (nxt % STAGES) * I8Tile<kRingBK>::kStage, xr, wr,
                     x, kt0 + nxt, p.K);
      cp_async_commit();
      if (busy) {
        const int8_t* st = smem + (it % STAGES) * I8Tile<kRingBK>::kStage;
        const int k0 = (kt0 + it) * kRingBK;
        const int8_t* xs = st + wm * 32 * LD;
        const int8_t* ws = st + kTM * LD + wn * 32 * LD;
        mma_step(acc, xs, ws, 0, LD);
        if (k0 + 32 < p.K) mma_step(acc, xs, ws, 32, LD);
      }
    }
    cp_async_wait<0>();
  }

  // The accumulators go through shared memory (the staging tiles are read
  // no more): a split tile adds them to its scratch with coalesced
  // atomics, and the epilogue walks the tile four columns a thread, so
  // its code appears once and its int8 stores are 4-byte words of
  // consecutive columns.
  __syncthreads();
  int* acc_s = reinterpret_cast<int*>(smem);  // kTM x kAccLD
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * 32 + mi * 16 + g + 8 * h;
        const int lc = wn * 32 + nj * 8 + 2 * t;
        *reinterpret_cast<int2*>(acc_s + lr * kAccLD + lc) =
            make_int2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
  __syncthreads();
  const int rows = min(kTM, p.R - r0);
  const int cols = min(kTN, p.N - n0);
  if (p.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* part = p.scratch + static_cast<size_t>(tile) * (kTM * kTN);
    for (int i = threadIdx.x; i < kTM * kTN; i += kI8Threads) {
      const int lr = i / kTN, lc = i - lr * kTN;
      if (lr < rows && lc < cols) atomicAdd(part + i, acc_s[lr * kAccLD + lc]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* ticket = p.tickets + tile;
      const int done = atomicAdd(ticket, 1);
      last_block = done == p.splits - 1;
      if (last_block) *ticket = 0;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    for (int i = threadIdx.x; i < kTM * kTN; i += kI8Threads) {
      const int lr = i / kTN, lc = i - lr * kTN;
      if (lr < rows && lc < cols) {
        acc_s[lr * kAccLD + lc] = __ldcg(part + i);
        __stcg(part + i, 0);
      }
    }
    __syncthreads();
  }

  switch (p.act) {
#define RT_K1_ACT(A) \
  case A:            \
    if (p.contract == kPlan)                                         \
      epilogue_tile<A, true>(p, acc_s, sc_s, bias_s, r0, n0, rows, cols); \
    else                                                             \
      epilogue_tile<A, false>(p, acc_s, sc_s, bias_s, r0, n0, rows, cols); \
    break;
    RT_K1_ACT(kNone) RT_K1_ACT(kRelu) RT_K1_ACT(kRelu6) RT_K1_ACT(kHswish)
    RT_K1_ACT(kHsigmoid) RT_K1_ACT(kSilu) RT_K1_ACT(kSigmoid)
    RT_K1_ACT(kGelu) RT_K1_ACT(kMish) RT_K1_ACT(kSqrelu) RT_K1_ACT(kLeaky)
#undef RT_K1_ACT
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
      store(p, b, m, n,
            epilogue_pallas(p, col_scale(p, n), __int_as_float(col_bias(p, n)),
                            acc[i][j], p.act));
    }
  }
}


// The int8 body's checks of what the wrapper's plan promised: the load
// width divides K, the strides and both base addresses; span mode has
// row-contiguous x and K <= 160; a split has scratch and tickets and at
// least one k-tile per split.
bool i8_plan_ok(const Params& p, int batch, int load) {
  if (load == kSpan) {
    const bool rows = p.x_sx == p.K &&
                      (p.x_ow >= p.M || p.x_sy == 1LL * p.x_ow * p.K) &&
                      (batch == 1 || p.x_bstride == 1LL * p.M * p.K);
    return rows && p.K <= kSpanK && p.splits == 1;
  }
  if (load != 16 && load != 8 && load != 4 && load != 1) return false;
  const unsigned long long bits =
      reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.w) |
      static_cast<unsigned long long>(p.K) |
      static_cast<unsigned long long>(p.x_sx) |
      static_cast<unsigned long long>(p.x_sy) |
      static_cast<unsigned long long>(p.x_bstride);
  if (bits % load != 0) return false;
  const int kt_all = (p.K + kRingBK - 1) / kRingBK;
  return p.splits >= 1 && p.splits <= kt_all &&
         (p.splits == 1 || (p.scratch && p.tickets));
}

// The int8 body's 17-42 KB of shared memory a block: asking for the
// largest shared-memory carveout (once per instance) lets the SM keep as
// many blocks as its registers allow.
template <int W, int MINB>
int launch_i8(const dim3& grid, const Params& p, cudaStream_t st) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      neutron_matmul_i8<W, MINB>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  const int smem = W == kSpan ? SpanSmem(p.K).bytes : ring_smem_bytes();
  neutron_matmul_i8<W, MINB><<<grid, kI8Threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes, devices and the int32 range of the accumulators.
// int8 inputs take the plan of kernels/neutron_matmul.py: `load` (16, 8,
// 4, 1, or 0 for span mode) and `splits`; with splits > 1, `scratch`
// holds ceil(R/64) * ceil(N/64) * 4096 int32 and `tickets` ceil(R/64) *
// ceil(N/64) int32, all 0 on entry (and again on exit).
extern "C" int neutron_matmul_launch(
    const void* x, const void* w, const void* scale, const void* bias,
    void* y, int batch, int M, int N, int K, long long x_bstride, int x_ow,
    long long x_sy, long long x_sx, long long y_bstride, int ldy,
    int in_dtype, int out_dtype, int contract, int act, int scale_per_col,
    int requant, float out_scale, int out_zp, int qmin, int qmax, int load,
    int splits, void* scratch, void* tickets, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || x_ow < 1 ||
      act < kNone || act > kLeaky ||
      (contract == kPlan && (in_dtype != kI8 || !scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, static_cast<const float*>(scale), bias, y, M, N, K,
           x_bstride, x_sy, x_sx, x_ow, y_bstride, ldy, contract, act,
           scale_per_col, requant, out_dtype, out_scale, out_zp, qmin, qmax,
           0, splits, static_cast<int*>(scratch), static_cast<int*>(tickets)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kI8) {
    const long long R = 1LL * batch * M;
    if (R > (1LL << 30) || (N + kTN - 1) / kTN > 65535 || splits > 65535 ||
        !i8_plan_ok(p, batch, load))
      return static_cast<int>(cudaErrorInvalidValue);
    p.R = static_cast<int>(R);
    const dim3 grid(static_cast<unsigned>((R + kTM - 1) / kTM),
                    (N + kTN - 1) / kTN, splits);
    switch (load) {
      case 16: return launch_i8<16, 1>(grid, p, st);
      case 8: return launch_i8<8, 1>(grid, p, st);
      case 4: return launch_i8<4, 1>(grid, p, st);
      case 1: return launch_i8<1, 1>(grid, p, st);
      default:
        return 8 * SpanSmem(p.K).bytes <= kSmemPerSM
                   ? launch_i8<kSpan, 8>(grid, p, st)
                   : launch_i8<kSpan, 1>(grid, p, st);
    }
  }
  if ((M + kBM - 1) / kBM > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  switch (in_dtype) {
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
