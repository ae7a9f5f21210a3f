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
// The float bodies (the Pallas contract for f32 and bf16 inputs: the
// float32 vision plan, the float32 LM decode path, and the tests) index
// rows over R = batch * M as the int8 body does, and take one of two
// routes, chosen per call by the wrapper (kernels/neutron_matmul.py
// float_plan, a pure function of R, N, K, the strides and the base
// addresses); the launch function refuses a plan that does not hold.
//
//   Skinny route (R <= 16: a decode step's ff in, ff out and logits, the
//   vision fc at batch 8), `neutron_matmul_skinny`.  What bounds it on an
//   H100 is bytes: w is read once and every row of x reuses it, so at
//   R = 1 a product does 2 operations per 4 bytes of w.  At the decoder's
//   shapes w is 2.4 MB (ff in, ff out: 0.7 us at 3.35 TB/s) and 80 MB
//   (logits: 24 us); the fc's is 5.1 MB (1.5 us).  Design: a GEMV.  A warp
//   owns 2 output columns and streams their rows of w (the natural (N, K)
//   layout, K-contiguous) with 16-byte loads where K, the strides and the
//   base addresses allow (else one element a load), each lane keeping the
//   sums of all R rows (R rounded up to 1, 2, 4, 8 or 16 in the instance)
//   in registers, x read through the read-only cache.  Where N is small
//   against the SMs (ff out: N = 384) the block's 8 warps split K instead
//   of taking more columns, so the grid still covers the SMs.  The sums
//   are reduced in a fixed order: each lane's strided partial, then
//   rt::warp_sum, then, where warps split K, a shared-memory sum in warp
//   order.  No atomics: a rerun gives the same bits.
//
//   Tiled route (R > 16: the stem im2col (100352 x 27 -> 32), the last 1x1
//   (392 x 320 -> 1280), the decoder's prefill logits (64 x 384 -> 51865),
//   every other float32-plan conv), `neutron_matmul_tiled`.  At those
//   shapes bytes bound it too (stem 23.6 MB, 7 us; prefill logits 80 MB,
//   24 us), but the scalar f32 units would not keep up (67 TFLOP/s: the
//   prefill logits' 2.6 GFLOP take 38 us there), so the products run on
//   the tensor cores in 3xTF32: `mma.sync.m16n8k8.tf32` on operands split
//   into hi (a with its low 13 mantissa bits cleared: a tf32 value) and lo
//   = a - hi (exact; the tensor core truncates it to tf32), a.b ~
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, accumulated in f32: float32
//   accuracy (each product within ~2^-19 of itself) at three times the
//   TF32 operations (15 us for the prefill logits at 495 TFLOP/s).  Plain
//   TF32 is never used.  A block of 4 warps owns a 64 x TN output tile (TN
//   32 where N <= 32, so the stem's tile is not half empty; else 64), each
//   warp 32 x TN/2; k-tiles of 32 elements are staged in shared memory as
//   f32 with `cp.async` (16-byte copies where the plan allows, else 4) in
//   a ring of 4 stages (fewer where a split has fewer k-tiles), rows
//   padded to 36 floats so that the fragment loads of a warp fall in 32
//   distinct banks, under the largest shared-memory carveout.  The three
//   products of a step are issued as three passes over the warp's tiles,
//   so that no two products into one accumulator are adjacent.  Where
//   the tile grid leaves SMs idle, K is split over blocks: each writes its
//   f32 partial tile to a scratch the wrapper keeps per stream, and the
//   tile's last block (an int32
//   ticket, reset to 0 after use) sums the partials in split order, not
//   with atomics, so a rerun gives the same bits.  bf16 inputs take the
//   same route with one TF32 product per step: a bf16 value converted to
//   f32 is exact in TF32, so hi = a and lo = 0 (the bf16 tiles are staged
//   through registers, converted, without `cp.async`).
//
//   Both routes run the Pallas epilogue (scale, bias, activation and
//   requantization as in the int8 body's Pallas contract) on each output
//   where it is computed.  What is left: `wgmma` with TMA-fed tiles for the
//   tiled route at large R, and a persistent skinny grid.

#include <cstdint>

#include "common.cuh"

namespace {

// float bodies
constexpr int kFThreads = 128;        // tiled: 4 warps, 2 x 2
constexpr int kFTM = 64;              // tiled: output rows per tile
constexpr int kFBK = 32;              // tiled: k elements per staged tile
constexpr int kFLD = kFBK + 4;        // tiled: staged row pitch in floats
constexpr int kFStages = 4;           // tiled: k-tiles in flight (ring)
constexpr int kSkWarps = 8;           // skinny: warps a block
constexpr int kSkCols = 2;            // skinny: output columns a warp
constexpr int kSkMaxR = 16;           // skinny: rows it takes
enum Route : int { kSkinny = 0, kTiled = 1 };

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
  // rows over batch * M, the k-split (skinny: warps splitting K) and its
  // scratch (int8: int32 sums; float: f32 partial tiles)
  int R, splits;
  int* scratch;
  float* part;
  int* tickets;
  // float bodies: row r of x lies at r * x_sx, and of y at r * ldy (rows
  // evenly spaced across images)
  int x_flat, y_flat;
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

// Output element idx of y (an offset in elements) in its dtype.
__device__ __forceinline__ void store_at(const Params& p, long long idx,
                                         float v) {
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

__device__ __forceinline__ void store(const Params& p, int b, int m, int n,
                                      float v) {
  store_at(p,
           static_cast<long long>(b) * p.y_bstride +
               static_cast<long long>(m) * p.ldy + n,
           v);
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

// --------------------------------------------------------------------------
// float: the skinny route (a GEMV) and the tiled route (3xTF32 mma.sync)
// --------------------------------------------------------------------------

// Offset in elements of row r (over batch * M) of x.
__device__ __forceinline__ long long f_row_offset(const Params& p, int r) {
  return p.x_flat ? static_cast<long long>(r) * p.x_sx : x_offset(p, r);
}

// The Pallas epilogue of output (r, n) from its f32 sum, stored in place.
__device__ __forceinline__ void store_pallas(const Params& p, int r, int n,
                                             float acc) {
  const int b = r / p.M;
  store(p, b, r - b * p.M, n,
        epilogue_pallas(p, col_scale(p, n), __int_as_float(col_bias(p, n)),
                        acc, p.act));
}

// VEC consecutive elements of x or w as f32: one 16-byte load (VEC = 4
// floats or 8 bf16) or one element.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* src, float (&v)[VEC]) {
  if constexpr (VEC == 1 && sizeof(T) == 4) {
    v[0] = __ldg(reinterpret_cast<const float*>(src));
  } else if constexpr (VEC == 1) {
    const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(src));
    v[0] = __uint_as_float(static_cast<uint32_t>(h) << 16);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "16 bytes of f32");
    const float4 f = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    static_assert(VEC == 8, "16 bytes of bf16");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The skinny route: grid ceil(N / (kSkCols * kSkWarps / splits)), 8 warps;
// warp `warp` takes columns n0 .. n0 + 1 over its K range, the block's
// `splits` warps of a column pair splitting K in equal runs of vectors.
// RB >= R rows (1, 2, 4, 8, 16); VEC elements a load (the plan's width).
template <typename T, int VEC, int RB>
__global__ void __launch_bounds__(kSkWarps * 32)
neutron_matmul_skinny(const Params p) {
  constexpr int C = kSkCols;
  static_assert(RB * C <= 32, "one lane per output of a warp");
  __shared__ float red[kSkWarps][RB * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kws = p.splits;              // warps splitting K
  const int kw = warp % kws, cg = warp / kws;
  const int n0 = (blockIdx.x * (kSkWarps / kws) + cg) * C;
  const int nvec = p.K / VEC;
  const int v0 = static_cast<int>(1LL * kw * nvec / kws);
  const int v1 = static_cast<int>(1LL * (kw + 1) * nvec / kws);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const T* xr[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) xr[r] = r < p.R ? x + f_row_offset(p, r) : x;
  const T* wr[C];
#pragma unroll
  for (int j = 0; j < C; ++j)
    wr[j] = w + static_cast<long long>(min(n0 + j, p.N - 1)) * p.K;

  float acc[RB][C];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int v = v0 + lane; v < v1; v += 32) {
    const int k = v * VEC;
    float wv[C][VEC];
#pragma unroll
    for (int j = 0; j < C; ++j) load_vec<T, VEC>(wr[j] + k, wv[j]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < p.R) {
        float xv[VEC];
        load_vec<T, VEC>(xr[r] + k, xv);
#pragma unroll
        for (int j = 0; j < C; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][j] = fmaf(xv[e], wv[j][e], acc[r][j]);
      }
    }
  }
  // Lane r * C + j keeps output (r, n0 + j) of this warp's K range.
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float s = rt::warp_sum(acc[r][j]);
      if (lane == r * C + j) mine = s;
    }
  const int r = lane / C, n = n0 + lane % C;
  const bool out = lane < RB * C && r < p.R && n < p.N;
  if (kws == 1) {
    if (out) store_pallas(p, r, n, mine);
    return;
  }
  if (lane < RB * C) red[warp][lane] = mine;
  __syncthreads();
  if (kw == 0 && out) {
    float s = 0.f;
    for (int i = 0; i < kws; ++i) s += red[warp + i][lane];
    store_pallas(p, r, n, s);
  }
}

using rt::mma_tf32;

// The operand halves of N values where SPLIT (f32 inputs): rt::tf32_hi_lo.
// Where not SPLIT (bf16 inputs, exact in tf32) hi = v.
template <bool SPLIT, int N>
__device__ __forceinline__ void tf32_split(const float (&v)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT) {
      rt::tf32_hi_lo(v[i], hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(v[i]);
      lo[i] = 0u;
    }
  }
}

// The tiled route's staging geometry for CW elements a copy: a thread
// stages rows rr, rr + RSTEP, ... of both operands at one column chunk.
template <int CW>
struct FStage {
  static constexpr int CPR = kFBK / CW;            // copies per row
  static constexpr int RSTEP = kFThreads / CPR;
};

// Stage k-tile kt of x (kFTM rows) and w (BN rows) into `st` as f32 at
// pitch kFLD: f32 by `cp.async` of CW floats (zero-filled past K and past
// the last row, whose pointer is null), bf16 element by element through
// registers.  `any` is a valid address that a zero-filled copy names.
template <typename T, int CW, int NX, int NW>
__device__ __forceinline__ void f_stage(float* st, const T* const (&xr)[NX],
                                        const T* const (&wr)[NW],
                                        const T* any, int kt, int K) {
  using G = FStage<CW>;
  const int cc = threadIdx.x % G::CPR;
  const int rr = threadIdx.x / G::CPR;
  const int k = kt * kFBK + cc * CW;
#pragma unroll
  for (int i = 0; i < NX + NW; ++i) {
    const T* src = i < NX ? xr[i] : wr[i - NX];
    const int row = i < NX ? rr + i * G::RSTEP : kFTM + rr + (i - NX) * G::RSTEP;
    float* dst = st + row * kFLD + cc * CW;
    const bool ok = src != nullptr && k < K;
    if constexpr (sizeof(T) == 4) {
      rt::cp_async<4 * CW>(dst, ok ? src + k : any, ok);
    } else {
      static_assert(CW == 1, "bf16 is staged one element a thread");
      *dst = ok ? rt::to_float(src[k]) : 0.f;
    }
  }
}

// The tiled route: grid (ceil(R / 64), ceil(N / BN), splits), 4 warps of
// 32 x BN/2 outputs (2 x BN/16 mma tiles of 16 x 8); k-tiles kt0 .. kt1 of
// this split through a ring of up to kFStages stages; f32 inputs in
// 3xTF32, bf16 in one TF32 product.  Dynamic shared memory: min(kFStages,
// the most k-tiles a split has) stages of (64 + BN) * kFLD floats.
template <typename T, int BN, int CW>
__global__ void __launch_bounds__(kFThreads)
neutron_matmul_tiled(const Params p) {
  using G = FStage<CW>;
  constexpr int NX = kFTM / G::RSTEP, NW = BN / G::RSTEP;
  constexpr int NJ = BN / 16;                       // n-tiles of a warp
  constexpr int STAGE = (kFTM + BN) * kFLD;
  constexpr bool SPLIT = sizeof(T) == 4;
  static_assert(kFTM % G::RSTEP == 0 && BN % G::RSTEP == 0, "whole rows");
  static_assert(NJ % 2 == 0, "B fragments two n-tiles a load");
  extern __shared__ __align__(16) float fsmem[];
  __shared__ int last_block;

  const int r0 = blockIdx.x * kFTM;
  const int n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int lm_row = lane & 7, lm_mat = lane >> 3;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  const T* xr[NX];
  const T* wr[NW];
  const int rr = threadIdx.x / G::CPR;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int r = r0 + rr + i * G::RSTEP;
    xr[i] = r < p.R ? x + f_row_offset(p, r) : nullptr;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int n = n0 + rr + i * G::RSTEP;
    wr[i] = n < p.N ? w + static_cast<long long>(n) * p.K : nullptr;
  }
  const int kt_all = (p.K + kFBK - 1) / kFBK;
  const int kt0 = static_cast<int>(1LL * blockIdx.z * kt_all / p.splits);
  const int kt1 = static_cast<int>(1LL * (blockIdx.z + 1) * kt_all / p.splits);
  const int nk = kt1 - kt0;

  float acc[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) f_stage<T, CW, NX, NW>(fsmem + s * STAGE, xr, wr, x, kt0 + s,
                                       p.K);
    rt::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    rt::cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile `it` has landed; tile it - 1 is consumed
    const int nxt = it + kFStages - 1;
    if (nxt < nk)
      f_stage<T, CW, NX, NW>(fsmem + (nxt % kFStages) * STAGE, xr, wr, x,
                             kt0 + nxt, p.K);
    rt::cp_async_commit();
    // Fragments by `ldmatrix`: a 32-bit element is a pair of 16-bit ones,
    // so matrix j of an x4 load gives lane (g, t) the float at row g,
    // column t of an 8 x 4 block of floats; lane l names row l % 8 of
    // block l / 8.
    const float* st = fsmem + (it % kFStages) * STAGE;
    const float* xs = st + (wm * 32 + (lm_mat & 1) * 8 + lm_row) * kFLD +
                      (lm_mat >> 1) * 4;
    const float* ws = st + (kFTM + wn * (BN / 2) + (lm_mat >> 1) * 8 +
                            lm_row) * kFLD + (lm_mat & 1) * 4;
#pragma unroll
    for (int kb = 0; kb < kFBK; kb += 8) {
      uint32_t ah[2][4], al[2][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t u[4];
        rt::ldmatrix_x4(u, xs + mi * 16 * kFLD + kb);
        const float v[4] = {__uint_as_float(u[0]), __uint_as_float(u[1]),
                            __uint_as_float(u[2]), __uint_as_float(u[3])};
        tf32_split<SPLIT, 4>(v, ah[mi], al[mi]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; nj += 2) {
        uint32_t u[4];
        rt::ldmatrix_x4(u, ws + nj * 8 * kFLD + kb);
        const float v0[2] = {__uint_as_float(u[0]), __uint_as_float(u[1])};
        const float v1[2] = {__uint_as_float(u[2]), __uint_as_float(u[3])};
        tf32_split<SPLIT, 2>(v0, bh[nj], bl[nj]);
        tf32_split<SPLIT, 2>(v1, bh[nj + 1], bl[nj + 1]);
      }
      // the small terms first, each pass over every tile, so that the
      // products into one accumulator are 2 * NJ instructions apart
      if constexpr (SPLIT) {
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_tf32(acc[mi][nj], al[mi], bh[nj][0], bh[nj][1]);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_tf32(acc[mi][nj], ah[mi], bl[nj][0], bl[nj][1]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_tf32(acc[mi][nj], ah[mi], bh[nj][0], bh[nj][1]);
    }
  }
  rt::cp_async_wait<0>();

  if (p.splits > 1) {
    // This split's partial tile into its slot of the scratch; the tile's
    // last block reads every split's back and sums them in split order.
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = p.part + (static_cast<size_t>(tile) * p.splits +
                            blockIdx.z) * (kFTM * BN);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = wm * 32 + mi * 16 + g + 8 * h;
          const int lc = wn * (BN / 2) + nj * 8 + 2 * t;
          __stcg(reinterpret_cast<float2*>(part + lr * BN + lc),
                 make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]));
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
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float* ps =
          p.part + (static_cast<size_t>(tile) * p.splits + s) * (kFTM * BN);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = wm * 32 + mi * 16 + g + 8 * h;
            const int lc = wn * (BN / 2) + nj * 8 + 2 * t;
            const float2 v =
                __ldcg(reinterpret_cast<const float2*>(ps + lr * BN + lc));
            acc[mi][nj][2 * h] += v.x;
            acc[mi][nj][2 * h + 1] += v.y;
          }
    }
  }

  // The epilogue: the tile's sums go through shared memory (the ring is
  // read no more) at a pitch of BN + 8 floats (a half-warp's float2 stores
  // fall in distinct banks); then each warp takes whole rows, a lane one
  // column in 32, so the stores of a row are consecutive and each lane's
  // column scale and bias are read once.
  constexpr int OLD = BN + 8;
  static_assert(kFTM * OLD <= STAGE, "the output tile fits one stage");
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * 32 + mi * 16 + g + 8 * h;
        const int lc = wn * (BN / 2) + nj * 8 + 2 * t;
        *reinterpret_cast<float2*>(fsmem + lr * OLD + lc) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
  __syncthreads();
  constexpr int CPL = BN / 32;          // columns a lane
  float sc[CPL], bi[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int n = min(n0 + lane + 32 * c, p.N - 1);
    sc[c] = col_scale(p, n);
    bi[c] = __int_as_float(col_bias(p, n));
  }
  const int rows = min(kFTM, p.R - r0);
  for (int lr = warp; lr < rows; lr += kFThreads / 32) {
    const int r = r0 + lr;
    const int b = p.y_flat ? 0 : r / p.M;
    const long long off = static_cast<long long>(b) * p.y_bstride +
                          static_cast<long long>(r - b * p.M) * p.ldy;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int lc = lane + 32 * c;
      if (n0 + lc < p.N)
        store_at(p, off + n0 + lc,
                 epilogue_pallas(p, sc[c], bi[c], fsmem[lr * OLD + lc],
                                 p.act));
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

// The float bodies' checks of what the wrapper's float_plan promised: a
// load of 16 bytes divides K, the strides (in bytes) and both base
// addresses, else loads are one element (`elem` bytes); the skinny route
// takes R <= 16 rows with 1, 2, 4 or 8 warps splitting K, each warp no
// fewer than one vector, and tile_n its block's columns; the tiled route
// takes R > 16, a tile of 32 or 64 columns (at most 65535 tiles across
// N) and at least one k-tile per split, a split with its scratch and
// tickets.
bool float_plan_ok(const Params& p, int elem, int load, int route,
                   int tile_n) {
  if (load == 16) {
    const unsigned long long bits =
        reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.w) |
        static_cast<unsigned long long>(p.K) * elem |
        static_cast<unsigned long long>(p.x_sx) * elem |
        static_cast<unsigned long long>(p.x_sy) * elem |
        static_cast<unsigned long long>(p.x_bstride) * elem;
    if (bits % 16 != 0) return false;
  } else if (load != elem) {
    return false;
  }
  if (route == kSkinny) {
    const int kws = p.splits;
    return p.R <= kSkMaxR && (kws == 1 || kws == 2 || kws == 4 || kws == 8) &&
           tile_n == kSkCols * kSkWarps / kws &&
           p.K / (load / elem) >= kws;
  }
  if (route == kTiled) {
    const int kt_all = (p.K + kFBK - 1) / kFBK;
    return p.R > kSkMaxR && (tile_n == 32 || tile_n == 64) &&
           (p.N + tile_n - 1) / tile_n <= 65535 && p.splits >= 1 && p.splits <= kt_all &&
           (p.splits == 1 || (p.part && p.tickets));
  }
  return false;
}

template <typename T, int VEC>
int launch_skinny(const Params& p, int tile_n, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((p.N + tile_n - 1) / tile_n));
  const int rb = p.R <= 1 ? 1 : p.R <= 2 ? 2 : p.R <= 4 ? 4 : p.R <= 8 ? 8
                                                                      : 16;
  switch (rb) {
#define RT_K1_SKINNY(RB)                                                   \
  case RB:                                                                 \
    neutron_matmul_skinny<T, VEC, RB><<<grid, kSkWarps * 32, 0, st>>>(p); \
    break;
    RT_K1_SKINNY(1) RT_K1_SKINNY(2) RT_K1_SKINNY(4) RT_K1_SKINNY(8)
    RT_K1_SKINNY(16)
#undef RT_K1_SKINNY
  }
  return static_cast<int>(cudaGetLastError());
}

// The tiled route's 14-74 KB of shared memory a block: the largest
// carveout (as for the int8 body) lets an SM hold as many blocks as its
// registers allow; a split with fewer k-tiles than the ring gets that
// many stages.
template <typename T, int BN, int CW>
int launch_tiled(const Params& p, cudaStream_t st) {
  static const cudaError_t attrs = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        neutron_matmul_tiled<T, BN, CW>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        neutron_matmul_tiled<T, BN, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFStages * (kFTM + BN) * kFLD * static_cast<int>(sizeof(float)));
  }();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const int kt_all = (p.K + kFBK - 1) / kFBK;
  const int stages = min(kFStages, (kt_all + p.splits - 1) / p.splits);
  const dim3 grid(static_cast<unsigned>((p.R + kFTM - 1) / kFTM),
                  (p.N + BN - 1) / BN, p.splits);
  const int smem =
      stages * (kFTM + BN) * kFLD * static_cast<int>(sizeof(float));
  neutron_matmul_tiled<T, BN, CW><<<grid, kFThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_float(const Params& p, int load, int route, int tile_n,
                 cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (route == kSkinny)
    return load == 16 ? launch_skinny<T, VEC>(p, tile_n, st)
                      : launch_skinny<T, 1>(p, tile_n, st);
  if constexpr (sizeof(T) == 4) {
    if (load == 16)
      return tile_n == 32 ? launch_tiled<T, 32, 4>(p, st)
                          : launch_tiled<T, 64, 4>(p, st);
  }
  return tile_n == 32 ? launch_tiled<T, 32, 1>(p, st)
                      : launch_tiled<T, 64, 1>(p, st);
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes, devices and the int32 range of the accumulators.
// int8 inputs take the plan of kernels/neutron_matmul.py: `load` (16, 8,
// 4, 1, or 0 for span mode) and `splits`; with splits > 1, `scratch`
// holds ceil(R/64) * ceil(N/64) * 4096 int32 and `tickets` ceil(R/64) *
// ceil(N/64) int32, all 0 on entry (and again on exit).  f32 and bf16
// inputs take its float_plan: `route` (0 skinny, 1 tiled), `tile_n`,
// `load` (16 or the element size) and `splits`; a tiled split has in
// `scratch` ceil(R/64) * ceil(N/tile_n) * splits * 64 * tile_n floats
// (no initial value) and in `tickets` one int32 a tile, 0 on entry (and
// again on exit).
extern "C" int neutron_matmul_launch(
    const void* x, const void* w, const void* scale, const void* bias,
    void* y, int batch, int M, int N, int K, long long x_bstride, int x_ow,
    long long x_sy, long long x_sx, long long y_bstride, int ldy,
    int in_dtype, int out_dtype, int contract, int act, int scale_per_col,
    int requant, float out_scale, int out_zp, int qmin, int qmax, int load,
    int splits, int route, int tile_n, void* scratch, void* tickets,
    void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || x_ow < 1 ||
      act < kNone || act > kLeaky ||
      (contract == kPlan && (in_dtype != kI8 || !scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, static_cast<const float*>(scale), bias, y, M, N, K,
           x_bstride, x_sy, x_sx, x_ow, y_bstride, ldy, contract, act,
           scale_per_col, requant, out_dtype, out_scale, out_zp, qmin, qmax,
           0, splits, static_cast<int*>(scratch),
           static_cast<float*>(scratch), static_cast<int*>(tickets)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long R = 1LL * batch * M;
  p.x_flat = (x_ow >= M || x_sy == 1LL * x_ow * x_sx) &&
             (batch == 1 || x_bstride == 1LL * M * x_sx);
  p.y_flat = batch == 1 || y_bstride == 1LL * M * ldy;
  if (in_dtype == kI8) {
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
  if (R > (1LL << 30) || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.R = static_cast<int>(R);
  switch (in_dtype) {
    case kF32:
      if (!float_plan_ok(p, 4, load, route, tile_n))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_float<float>(p, load, route, tile_n, st);
    case kBF16:
      if (!float_plan_ok(p, 2, load, route, tile_n))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_float<__nv_bfloat16>(p, load, route, tile_n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
