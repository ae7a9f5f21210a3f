// The backward of flash attention (K2b): dq, dk and dv of K2's forward
// from its residuals (q, k, v, o, lse) and the output's cotangent do.
//
// Replaces `_faf_bwd` of src/repro/kernels/ref.py (lines 236-285), the
// custom VJP of `flash_attention_fused`, which the JAX package writes in
// jnp: no Pallas kernel of its own.  The same function, for q (B,H,S,D),
// k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o and do (B,H,S,Dv), lse (B,H,S) float32,
// H % Hkv == 0, query head h reading kv head h / (H / Hkv):
//   delta_i = sum_d do_id o_id                      (float32)
//   P_ij    = exp(s_ij sm_scale - lse_i) where key j is valid for row i
//             (j <= i when causal, i - j < window when a window is given),
//             else 0; s_ij = q_i . k_j
//   dV_j   += sum_i P_ij do_i,   dS_ij = P_ij (do_i . v_j - delta_i) sm_scale
//   dK_j   += sum_i dS_ij q_i,   dQ_i  = sum_j dS_ij k_j
// dK and dV sum over the query heads of the kv head's group.  Every sum is
// taken in float32 from inputs of either dtype (the mma route rounds P and
// dS to bf16 for their products); the outputs are rounded to the inputs'
// dtype.
//
// Each dtype and head dim has one of two bodies, the route chosen per call
// by the wrapper (kernels/flash_attention_bwd.py bwd_plan, a pure function
// of the dtype, D and Dv); the launch function refuses a call whose route
// does not fit it.  Both are deterministic, with no atomics: a restarted
// run reproduces its bits.
//
// What bounds K2b on an H100: at the training shape (minitron-4b: 8 x 32
// heads x 128 positions x head dim 128, causal) the backward does 2.5x the
// forward's operations, 2.7 GFLOP a layer, 2.7 us on the bf16 tensor
// cores; its inputs and outputs are 67 MB, 20 us at 3.35 TB/s, so bytes
// bound it.  At gemma3's window of 1024 over 1040 positions the operations
// (22 GFLOP, 22 us) bound it; a group of 48 query heads over one kv head
// (granite-20b) reads 6 MB and has 8 key tiles for 132 SMs.
//
// mma route (bf16 with D and Dv multiples of 16 up to 192: every trained
// path), on the tensor cores with K2's fragments (common.cuh).  Four
// launches (five or six with a group split):
//   1. `delta_kernel`: one warp per row, delta = rowsum(do o).
//   2. `dkdv_mma_kernel`: one block of 4 warps per (b, kv head, slice of
//      the group, tile of 64 keys), each warp 16 keys.  K and V of the tile
//      stay in shared memory; the block walks its slice's query heads and
//      the query tiles of 64 rows that the mask admits, staged (Q, dO, lse,
//      delta) with `cp.async`, double-buffered, rows padded by 16 bytes.
//      Per 32 query rows a warp computes S^T = K Q^T and dP^T = V dO^T on
//      `mma.sync.m16n8k16`, then P^T = exp2(S^T scale log2e - lse log2e)
//      under K2's masks and dS^T = P^T (dP^T - delta) scale in f32; P^T and
//      dS^T are rounded to bf16 and fed from registers as A fragments into
//      dV += P^T dO and dK += dS^T Q (B fragments by `ldmatrix.trans`), as
//      K2's forward feeds P into P V.  A warp skips the 32 rows its keys
//      cannot see, the block the query tiles none of its keys can.
//   3. Where B * Hkv * key tiles would leave the SMs short (granite-20b: 8
//      blocks), the group's query heads are split over G slices on the grid
//      (G divides the group; the wrapper's group_split).  Each slice writes
//      f32 partials of dK and dV to a scratch the wrapper allocates, and
//      `group_sum_kernel` sums the G partials in slice order, then rounds.
//   4. `dq_mma_kernel`: one block of 4 warps per (b, head, 64 query rows),
//      Q, dO, lse and delta staged once, the admitted key tiles of 64 walked
//      with K and V double-buffered; the same products give dS, and dQ +=
//      dS K.  The heavier late causal tiles are launched first.
//   Rounding: P and dS are rounded to bf16 for their products (as PyTorch's
//   flash backward does); every sum is f32.
//
// scalar route (float32 inputs, and D or Dv not a multiple of 16 or above
// 192), the first version's, scalar f32 FMAs from shared memory:
//   1. `delta_kernel` as above.
//   2. `dkdv_kernel`: one block per (b, kv head, tile of 32 keys).  K and V
//      of the tile stay in shared memory; the block walks the group's query
//      heads and the query tiles of 32 rows that the mask admits (causal:
//      from the tile holding the first key on; window: up to the last key
//      + window - 1), recomputes P and dS for each, and accumulates dV and
//      dK in registers (a warp owns 4 key rows, a lane its columns).
//   3. `dq_kernel`: one block per (b, head, tile of 32 query rows), Q, dO,
//      lse and delta in shared memory; it walks the key tiles the mask
//      admits and accumulates dQ in registers the same way.
//   Both recompute P and dS of a (query tile, key tile) pair with the same
//   routine: each thread scores one query row against four key rows with
//   scalar f32 FMAs from shared memory (rows padded by one float, so the
//   lanes' rows fall in distinct banks).  On the scalar f32 units (67
//   TFLOP/s) with a shared-memory load per two FMAs it is bound by
//   operations on the wrong unit; it stays for float32, where the tensor
//   cores' bf16 would not hold float32 tolerances.
//
// What is left: `wgmma` with TMA-fed tiles, and dQ computed in the dK/dV
// pass where a deterministic reduction allows it.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                  // query rows per tile (= lanes)
constexpr int kBK = 32;                  // keys per tile
constexpr int kRows = kBK / kWarps;      // rows a warp owns: 4
constexpr int kLDP = kBQ + 1;            // pitch of the P and dS tiles
static_assert(kBQ == 32, "phase 1 maps a query row to each lane");
static_assert(kBQ == kBK, "one row split serves both kernels");

// Shared memory of both kernels: Q, dO (kBQ rows), K, V (kBK rows), each
// row padded to LD = 32 NC + 1 floats and zero past its width; P and dS
// (kBK x kLDP); lse and delta (kBQ).
template <int NC>
struct Smem {
  static constexpr int W = 32 * NC;   // columns held per row
  static constexpr int LD = W + 1;
  static constexpr size_t kFloats =
      static_cast<size_t>(2 * kBQ + 2 * kBK) * LD + 2 * kBK * kLDP + 2 * kBQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// rows [row0, row0 + rows) of a (n_valid x width) matrix into shared memory
// as f32 at pitch LD, zero past n_valid rows and past width columns.
template <typename T, int NC>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int rows, int n_valid, int width) {
  constexpr int W = Smem<NC>::W;
  constexpr int LD = Smem<NC>::LD;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W;
    const int c = i - r * W;
    dst[r * LD + c] = (row0 + r < n_valid && c < width)
                          ? rt::to_float(src[static_cast<size_t>(row0 + r) *
                                                 width + c])
                          : 0.f;
  }
}

// P and dS of query rows i0 .. i0 + 31 against keys k0 .. k0 + 31, into
// p_s and ds_s at [key row][query row].  Thread: query row = lane, key rows
// warp + 8 r.  Rows past S and keys past Sk get P = dS = 0.
template <int NC>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       const float* lse_s,
                                       const float* delta_s, float* p_s,
                                       float* ds_s, int i0, int k0, int S,
                                       int Sk, int D, int Dv, float sm_scale,
                                       int causal, int window) {
  constexpr int LD = Smem<NC>::LD;
  const int i = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  const float* qr = q_s + i * LD;
  for (int d = 0; d < D; ++d) {
    const float qv = qr[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] += qv * k_s[(w + kWarps * r) * LD + d];
  }
  const float* dor = do_s + i * LD;
  for (int d = 0; d < Dv; ++d) {
    const float dv = dor[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      dp[r] += dv * v_s[(w + kWarps * r) * LD + d];
  }
  const int qi = i0 + i;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = w + kWarps * r;
    const int kj = k0 + j;
    bool ok = qi < S && kj < Sk;
    if (causal) ok = ok && kj <= qi;
    if (window > 0) ok = ok && qi - kj < window;
    const float p = ok ? expf(s[r] * sm_scale - lse_s[i]) : 0.f;
    p_s[j * kLDP + i] = p;
    ds_s[j * kLDP + i] = p * (dp[r] - delta_s[i]) * sm_scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int Dv) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + static_cast<size_t>(row) * Dv;
  const T* dp = dout + static_cast<size_t>(row) * Dv;
  float acc = 0.f;
  for (int d = lane; d < Dv; d += 32)
    acc += rt::to_float(op[d]) * rt::to_float(dp[d]);
  acc = rt::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Q, dO, lse and delta of query rows i0 .. i0 + 31 of head (b, h).
template <typename T, int NC>
__device__ __forceinline__ void load_queries(
    float* q_s, float* do_s, float* lse_s, float* delta_s, const T* qp,
    const T* dop, const float* lsep, const float* deltap, int i0, int S,
    int D, int Dv) {
  load_rows<T, NC>(q_s, qp, i0, kBQ, S, D);
  load_rows<T, NC>(do_s, dop, i0, kBQ, S, Dv);
  if (threadIdx.x < kBQ) {
    const int qi = i0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < S ? lsep[qi] : 0.f;
    delta_s[threadIdx.x] = qi < S ? deltap[qi] : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S,
            int Sk, int D, int Dv, float sm_scale, int causal, int window) {
  using L = Smem<NC>;
  constexpr int LD = L::LD;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ * LD;
  float* k_s = do_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  float* ds_s = p_s + kBK * kLDP;
  float* lse_s = ds_s + kBK * kLDP;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;
  load_rows<T, NC>(k_s, k + kv_head * Sk * D, k0, kBK, Sk, D);
  load_rows<T, NC>(v_s, v + kv_head * Sk * Dv, k0, kBK, Sk, Dv);

  // the query tiles some row of which sees a key of this tile
  const int i_begin = causal ? (k0 / kBQ) * kBQ : 0;
  const int i_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;

  float acc_k[kRows][NC], acc_v[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_k[r][n] = acc_v[r][n] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const size_t head = static_cast<size_t>(b) * H + h;
    for (int i0 = i_begin; i0 < i_end; i0 += kBQ) {
      __syncthreads();  // the previous tile's reads of q_s .. ds_s are done
      load_queries<T, NC>(q_s, do_s, lse_s, delta_s, q + head * S * D,
                          dout + head * S * Dv, lse + head * S,
                          delta + head * S, i0, S, D, Dv);
      __syncthreads();
      scores<NC>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, i0, k0, S,
                 Sk, D, Dv, sm_scale, causal, window);
      __syncthreads();
      // dV[j] += sum_i P[j][i] dO[i];  dK[j] += sum_i dS[j][i] Q[i]
      for (int i = 0; i < kBQ; ++i) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          qv[n] = q_s[i * LD + lane + 32 * n];
          dov[n] = do_s[i * LD + lane + 32 * n];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = p_s[(w + kWarps * r) * kLDP + i];
          const float ds = ds_s[(w + kWarps * r) * kLDP + i];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            acc_v[r][n] += p * dov[n];
            acc_k[r][n] += ds * qv[n];
          }
        }
      }
    }
  }

  T* dkp = dk + kv_head * Sk * D;
  T* dvp = dv + kv_head * Sk * Dv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + w + kWarps * r;
    if (kj >= Sk) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = lane + 32 * n;
      if (c < D)
        dkp[static_cast<size_t>(kj) * D + c] = rt::from_float<T>(acc_k[r][n]);
      if (c < Dv)
        dvp[static_cast<size_t>(kj) * Dv + c] = rt::from_float<T>(acc_v[r][n]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Hkv, int S, int Sk, int D, int Dv,
          float sm_scale, int causal, int window) {
  using L = Smem<NC>;
  constexpr int LD = L::LD;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ * LD;
  float* k_s = do_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  float* ds_s = p_s + kBK * kLDP;
  float* lse_s = ds_s + kBK * kLDP;
  float* delta_s = lse_s + kBQ;

  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  const size_t head = static_cast<size_t>(b) * H + h;
  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;
  load_queries<T, NC>(q_s, do_s, lse_s, delta_s, q + head * S * D,
                      dout + head * S * Dv, lse + head * S, delta + head * S,
                      i0, S, D, Dv);

  // the key tiles some row of this query tile sees
  const int k_end = causal ? min(Sk, i0 + kBQ) : Sk;
  int k_begin = 0;
  if (window > 0) {
    const int lo = i0 - window + 1;  // first key row i0 sees
    if (lo > 0) k_begin = (lo / kBK) * kBK;
  }

  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of k_s .. ds_s are done
    load_rows<T, NC>(k_s, k + kv_head * Sk * D, k0, kBK, Sk, D);
    load_rows<T, NC>(v_s, v + kv_head * Sk * Dv, k0, kBK, Sk, Dv);
    __syncthreads();
    scores<NC>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, i0, k0, S, Sk,
               D, Dv, sm_scale, causal, window);
    __syncthreads();
    // dQ[i] += sum_j dS[j][i] K[j]; this warp's rows i = w + 8 r
    for (int j = 0; j < kBK; ++j) {
      float kv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) kv[n] = k_s[j * LD + lane + 32 * n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ds = ds_s[j * kLDP + w + kWarps * r];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[r][n] += ds * kv[n];
      }
    }
  }

  T* dqp = dq + head * S * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = i0 + w + kWarps * r;
    if (qi >= S) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = lane + 32 * n;
      if (c < D)
        dqp[static_cast<size_t>(qi) * D + c] = rt::from_float<T>(acc[r][n]);
    }
  }
}

// --------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using rt::cp_async;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma_bf16;

enum Route : int { kScalar = 0, kMma = 1 };
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMT = 16 * kMmaWarps;      // keys (dkdv) or query rows (dq) a block
constexpr int kMaxMmaD = 192;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of both mma kernels for D and Dv padded to DP and DVP: the
// block's own pair of tiles (K, V or Q, dO), two stages of the walked pair
// (Q, dO or K, V), each tile kMT rows at a pitch of 16 bytes more than its
// width, then per stage kMT lse and kMT delta values.
template <int DP, int DVP>
struct MmaSmem {
  static constexpr int LDK = DP + 8;
  static constexpr int LDV = DVP + 8;
  static constexpr int kPair = kMT * (LDK + LDV);   // bf16 elements
  static constexpr size_t kBytes =
      sizeof(bf16) * 3 * kPair + sizeof(float) * 2 * 2 * kMT;
};

// Rows [row0, row0 + kMT) of a (n_valid x width) bf16 matrix into shared
// memory at pitch LD with 16-byte copies, zero past n_valid rows and past
// width (a multiple of 8) up to DPAD columns.
template <int LD, int DPAD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n_valid, int width) {
  constexpr int CH = DPAD / 8;
  for (int i = threadIdx.x; i < kMT * CH; i += kMmaThreads) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = row0 + r < n_valid && c * 8 < width;
    const bf16* g =
        ok ? src + static_cast<size_t>(row0 + r) * width + c * 8 : src;
    cp_async<16>(dst + r * LD + c * 8, g, ok);
  }
}

// Values [row0, row0 + kMT) of a float vector of n_valid, zero past it.
__device__ __forceinline__ void load_rowvec(float* dst, const float* src,
                                            int row0, int n_valid) {
  for (int i = threadIdx.x; i < kMT; i += kMmaThreads) {
    const bool ok = row0 + i < n_valid;
    cp_async<4>(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// c (16 x 32) += A B^T for the warp: A's 16 rows and B's 32 rows of DEPTH
// columns in shared memory at pitch LD; c[j] is n-tile j (8 columns).
template <int DEPTH, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[4][4], const bf16* a_s,
                                        const bf16* b_s) {
  const int lane = threadIdx.x & 31;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (lm_row + (lm_mat & 1) * 8) * LD + kk * 16 +
                       (lm_mat >> 1) * 8);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (j * 8 + lm_row + (lm_mat >> 1) * 8) * LD +
                         kk * 16 + (lm_mat & 1) * 8);
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x NCOL) += X Y for the warp: X (16 x 32) as two A fragments in
// registers, Y's 32 rows of NCOL columns in shared memory at pitch LD.
template <int NCOL, int LD>
__device__ __forceinline__ void mma_xy(float (&acc)[NCOL / 8][4],
                                       const uint32_t (&x)[2][4],
                                       const bf16* y_s) {
  const int lane = threadIdx.x & 31;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int n = 0; n < NCOL / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, y_s + (kk * 16 + lm_row + (lm_mat & 1) * 8) * LD +
                               n * 8 + (lm_mat >> 1) * 8);
      mma_bf16(acc[n], x[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], x[kk], b[2], b[3]);
    }
}

// A 16 x 32 accumulator (4 n-tiles) rounded to bf16 as the two A fragments
// of a product over its 32 columns.
__device__ __forceinline__ void pack_a(const float (&c)[4][4],
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(c[j][2 * r], c[j][2 * r + 1]);
      a[j >> 1][(j & 1) * 2 + r] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// The warp's 16 rows (row0 + g, row0 + g + 8) x NCOL accumulated columns,
// those below n_rows and width, as bf16 pairs into dst (pitch width) or,
// with part, as f32 pairs into part (pitch width).
template <int NCOL>
__device__ __forceinline__ void store_rows(const float (&acc)[NCOL / 8][4],
                                           bf16* dst, float* part, int row0,
                                           int n_rows, int width) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NCOL / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c >= width) continue;
      const size_t i = static_cast<size_t>(row) * width + c;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + i) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst + i) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// dK and dV of one tile of kMT keys of kv head blockIdx.y / G, summed over
// the query heads of slice blockIdx.y % G of its group (group / G heads).
// Grid (ceil(Sk / kMT), Hkv * G, B).  With G > 1 the f32 sums go to
// part_k (G, B, Hkv, Sk, D) and part_v (G, B, Hkv, Sk, Dv).
template <int DP, int DVP>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ part_k,
                float* __restrict__ part_v, int H, int Hkv, int S, int Sk,
                int D, int Dv, float sm_scale, int causal, int window,
                int G) {
  using L = MmaSmem<DP, DVP>;
  constexpr int LDK = L::LDK, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kMT * LDK;
  bf16* st_s = k_s + L::kPair;              // stage s: Q, then dO
  float* f_s = reinterpret_cast<float*>(k_s + 3 * L::kPair);

  const int k0 = blockIdx.x * kMT;
  const int hk = blockIdx.y / G;
  const int slice = blockIdx.y - hk * G;
  const int b = blockIdx.z;
  const int hps = H / Hkv / G;              // query heads of a slice
  const int h_first = hk * (H / Hkv) + slice * hps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;

  load_tile<LDK, DP>(k_s, k + kv_head * Sk * D, k0, Sk, D);
  load_tile<LDV, DVP>(v_s, v + kv_head * Sk * Dv, k0, Sk, Dv);

  // the query tiles some row of which sees a key of this tile
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(S, k0 + kMT - 1 + window) : S;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + kMT - 1) / kMT : 0;
  const int n_items = hps * n_qt;
  auto load_item = [&](int item, int stage) {
    const int hh = item / n_qt;
    const int i0 = i_begin + (item - hh * n_qt) * kMT;
    const size_t head = static_cast<size_t>(b) * H + h_first + hh;
    bf16* qs = st_s + stage * L::kPair;
    load_tile<LDK, DP>(qs, q + head * S * D, i0, S, D);
    load_tile<LDV, DVP>(qs + kMT * LDK, dout + head * S * Dv, i0, S, Dv);
    load_rowvec(f_s + stage * 2 * kMT, lse + head * S, i0, S);
    load_rowvec(f_s + stage * 2 * kMT + kMT, delta + head * S, i0, S);
  };
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  float dk_acc[DP / 8][4], dv_acc[DVP / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const float scale_log2 = sm_scale * kLog2e;
  const int kw0 = k0 + 16 * warp;           // this warp's first key
  const bf16* kw_s = k_s + 16 * warp * LDK;
  const bf16* vw_s = v_s + 16 * warp * LDV;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load_item(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // item `it` (and K, V) have landed
    const bf16* qs = st_s + (it & 1) * L::kPair;
    const bf16* dos = qs + kMT * LDK;
    const float* lse_s = f_s + (it & 1) * 2 * kMT;
    const float* delta_s = lse_s + kMT;
    const int i0 = i_begin + (it % n_qt) * kMT;
#pragma unroll 1
    for (int c0 = 0; c0 < kMT; c0 += 32) {
      const int qa = i0 + c0;               // first query row of these 32
      // a warp whose keys no row of these 32 sees skips them
      const bool skip = qa >= S || (causal && qa + 31 < kw0) ||
                        (window > 0 && qa - (kw0 + 15) >= window);
      if (skip) continue;
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mma_abt<DP, LDK>(s, kw_s, qs + c0 * LDK);
      mma_abt<DVP, LDV>(dp, vw_s, dos + c0 * LDV);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kw0 + g + 8 * (e >> 1);
          const int ql = c0 + j * 8 + 2 * t + (e & 1);
          const int qi = i0 + ql;
          bool ok = qi < S && kj < Sk;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && qi - kj < window;
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - lse_s[ql] * kLog2e) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[ql]) * sm_scale;
        }
      uint32_t pa[2][4], dsa[2][4];
      pack_a(s, pa);
      pack_a(dp, dsa);
      mma_xy<DVP, LDV>(dv_acc, pa, dos + c0 * LDV);
      mma_xy<DP, LDK>(dk_acc, dsa, qs + c0 * LDK);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  cp_async_wait<0>();

  const size_t slice_off =
      static_cast<size_t>(slice) * gridDim.z * Hkv * Sk;
  store_rows<DP>(dk_acc, dk + kv_head * Sk * D,
                 G > 1 ? part_k + (slice_off + kv_head * Sk) * D : nullptr,
                 kw0, Sk, D);
  store_rows<DVP>(dv_acc, dv + kv_head * Sk * Dv,
                  G > 1 ? part_v + (slice_off + kv_head * Sk) * Dv : nullptr,
                  kw0, Sk, Dv);
}

// out[i] = bf16(sum over s < G, in order, of part[s * n + i]).
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                 size_t n, int G) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < G; ++s) acc += part[s * n + i];
    out[i] = __float2bfloat16(acc);
  }
}

// dQ of kMT query rows of head (b, blockIdx.y): grid (ceil(S / kMT), H,
// B), the last causal tiles (which see the most keys) first.
template <int DP, int DVP>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int Hkv, int S, int Sk, int D,
              int Dv, float sm_scale, int causal, int window) {
  using L = MmaSmem<DP, DVP>;
  constexpr int LDK = L::LDK, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kMT * LDK;
  bf16* st_s = q_s + L::kPair;              // stage s: K, then V
  float* lse_s = reinterpret_cast<float*>(q_s + 3 * L::kPair);
  float* delta_s = lse_s + kMT;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int i0 = qt * kMT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = static_cast<size_t>(b) * H + h;
  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;

  load_tile<LDK, DP>(q_s, q + head * S * D, i0, S, D);
  load_tile<LDV, DVP>(do_s, dout + head * S * Dv, i0, S, Dv);
  load_rowvec(lse_s, lse + head * S, i0, S);
  load_rowvec(delta_s, delta + head * S, i0, S);

  // the key tiles some row of this query tile sees
  const int k_end = causal ? min(Sk, i0 + kMT) : Sk;
  int k_begin = 0;
  if (window > 0) {
    const int lo = i0 - window + 1;  // first key row i0 sees
    if (lo > 0) k_begin = (lo / kMT) * kMT;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kMT - 1) / kMT : 0;
  auto load_kv = [&](int tile, int stage) {
    bf16* ks = st_s + stage * L::kPair;
    const int kt0 = k_begin + tile * kMT;
    load_tile<LDK, DP>(ks, k + kv_head * Sk * D, kt0, Sk, D);
    load_tile<LDV, DVP>(ks + kMT * LDK, v + kv_head * Sk * Dv, kt0, Sk, Dv);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  float dq_acc[DP / 8][4];
  zero(dq_acc);
  const float scale_log2 = sm_scale * kLog2e;
  const int qw0 = i0 + 16 * warp;           // this warp's first row
  const bf16* qw_s = q_s + 16 * warp * LDK;
  const bf16* dow_s = do_s + 16 * warp * LDV;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile `it` (and Q, dO, lse, delta) have landed
    const bf16* ks = st_s + (it & 1) * L::kPair;
    const bf16* vs = ks + kMT * LDK;
    const int kt0 = k_begin + it * kMT;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[r] = lse_s[16 * warp + g + 8 * r] * kLog2e;
      delta_r[r] = delta_s[16 * warp + g + 8 * r];
    }
#pragma unroll 1
    for (int c0 = 0; c0 < kMT; c0 += 32) {
      const int ka = kt0 + c0;              // first key of these 32
      // a warp whose rows see none of these 32 keys skips them
      const bool skip = qw0 >= S || ka >= Sk || (causal && ka > qw0 + 15) ||
                        (window > 0 && qw0 - (ka + 31) >= window);
      if (skip) continue;
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mma_abt<DP, LDK>(s, qw_s, ks + c0 * LDK);
      mma_abt<DVP, LDV>(dp, dow_s, vs + c0 * LDV);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = qw0 + g + 8 * r;
          const int kj = ka + j * 8 + 2 * t + (e & 1);
          bool ok = qi < S && kj < Sk;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && qi - kj < window;
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_r[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[r]) * sm_scale;
        }
      uint32_t dsa[2][4];
      pack_a(s, dsa);
      mma_xy<DP, LDK>(dq_acc, dsa, ks + c0 * LDK);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  cp_async_wait<0>();
  store_rows<DP>(dq_acc, dq + head * S * D, nullptr, qw0, S, D);
}

template <int DP, int DVP>
int launch_mma_dp(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* dout, const float* lse, const float* delta,
                  bf16* dq, bf16* dk, bf16* dv, float* scratch, int B, int H,
                  int Hkv, int S, int Sk, int D, int Dv, float sm_scale,
                  int causal, int window, int G, cudaStream_t stream) {
  const int smem = static_cast<int>(MmaSmem<DP, DVP>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_mma_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t nk = static_cast<size_t>(B) * Hkv * Sk * D;
  const size_t nv = static_cast<size_t>(B) * Hkv * Sk * Dv;
  float* part_k = scratch;
  float* part_v = G > 1 ? scratch + G * nk : nullptr;
  const dim3 grid_kv((Sk + kMT - 1) / kMT, Hkv * G, B);
  dkdv_mma_kernel<DP, DVP><<<grid_kv, kMmaThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part_k, part_v, H, Hkv, S, Sk, D, Dv,
      sm_scale, causal, window, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 1) {
    const size_t bk = (nk + 255) / 256, bv = (nv + 255) / 256;
    group_sum_kernel<<<static_cast<unsigned>(bk < 65535 ? bk : 65535), 256,
                       0, stream>>>(part_k, dk, nk, G);
    group_sum_kernel<<<static_cast<unsigned>(bv < 65535 ? bv : 65535), 256,
                       0, stream>>>(part_v, dv, nv, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_q((S + kMT - 1) / kMT, H, B);
  dq_mma_kernel<DP, DVP><<<grid_q, kMmaThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Hkv, S, Sk, D, Dv, sm_scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// The mma route: delta, then the bf16 bodies for D and Dv each padded to
// a multiple of 32 (192 / 128 has its own instance; other unequal pairs
// run at the larger of the two).
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, float* scratch, int B, int H, int Hkv,
               int S, int Sk, int D, int Dv, float sm_scale, int causal,
               int window, int G, cudaStream_t stream) {
  const int rows = B * H * S;
  delta_kernel<bf16><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      rows, Dv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = (D + 31) / 32 * 32, dvp = (Dv + 31) / 32 * 32;
  const int key = dp == 192 && dvp == 128 ? -1 : max(dp, dvp);
  switch (key) {
#define RT_FAB_MMA(DP, DVP)                                                \
  return launch_mma_dp<DP, DVP>(                                           \
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),           \
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,   \
      delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),              \
      static_cast<bf16*>(dv), scratch, B, H, Hkv, S, Sk, D, Dv, sm_scale, \
      causal, window, G, stream);
    case -1: RT_FAB_MMA(192, 128)
    case 32: RT_FAB_MMA(32, 32)
    case 64: RT_FAB_MMA(64, 64)
    case 96: RT_FAB_MMA(96, 96)
    case 128: RT_FAB_MMA(128, 128)
    case 160: RT_FAB_MMA(160, 160)
    case 192: RT_FAB_MMA(192, 192)
#undef RT_FAB_MMA
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, float* delta, T* dq, T* dk, T* dv, int B,
              int H, int Hkv, int S, int Sk, int D, int Dv, float sm_scale,
              int causal, int window, cudaStream_t stream) {
  const int rows = B * H * S;
  delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      o, dout, delta, rows, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = static_cast<int>(Smem<NC>::kBytes);
  err = cudaFuncSetAttribute(dkdv_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((Sk + kBK - 1) / kBK, Hkv, B);
  dkdv_kernel<T, NC><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Hkv, S, Sk, D, Dv, sm_scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_q((S + kBQ - 1) / kBQ, H, B);
  dq_kernel<T, NC><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Hkv, S, Sk, D, Dv, sm_scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int S, int Sk, int D,
           int Dv, float sm_scale, int causal, int window,
           cudaStream_t stream) {
  // columns a lane holds: 32 per slot, the head dims rounded up to 1, 2,
  // 4, 6 or 8 slots
  int nc = (max(D, Dv) + 31) / 32;
  nc = nc <= 2 ? nc : (nc <= 4 ? 4 : (nc <= 6 ? 6 : 8));
  switch (nc) {
#define RT_FAB_CASE(NC)                                                      \
  case NC:                                                                   \
    return launch_nc<T, NC>(                                                 \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<const T*>(o),                  \
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),        \
        static_cast<T*>(dk), static_cast<T*>(dv), B, H, Hkv, S, Sk, D, Dv,   \
        sm_scale, causal, window, stream);
    RT_FAB_CASE(1) RT_FAB_CASE(2) RT_FAB_CASE(4) RT_FAB_CASE(6)
    RT_FAB_CASE(8)
#undef RT_FAB_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the last launch (0 on success).  The
// caller checks shapes, dtypes and contiguity: q (B,H,S,D), k (B,Hkv,Sk,D),
// v (B,Hkv,Sk,Dv), o and dout (B,H,S,Dv) and the outputs dq, dk, dv of the
// inputs' shapes, all contiguous in one dtype; lse and the scratch delta
// float32 (B,H,S).  window <= 0 means no window.  `route` is the wrapper's
// bwd_plan: 0 (scalar; D and Dv at most 256, G = 1) or 1 (mma: bf16, D and
// Dv multiples of 16 up to 192, 16-byte aligned tensors, G dividing the
// group, with G > 1 a float32 scratch of G * B * Hkv * Sk * (D + Dv)).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int Sk, int D, int Dv,
    float sm_scale, int causal, int window, int dtype, int route, int G,
    void* scratch, void* stream) {
  if (D > 256 || Dv > 256 || D < 1 || Dv < 1 || Hkv <= 0 || H % Hkv != 0 ||
      G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_p = static_cast<const float*>(lse);
  float* delta_p = static_cast<float*>(delta);
  if (route == kMma) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
    const int group = H / Hkv;
    if (dtype != rt::kBF16 || D % 16 != 0 || Dv % 16 != 0 ||
        D > kMaxMmaD || Dv > kMaxMmaD || addr % 16 != 0 || group % G != 0 ||
        1LL * Hkv * G > 65535 || (G > 1 && scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(q, k, v, o, dout, lse_p, delta_p, dq, dk, dv,
                      static_cast<float*>(scratch), B, H, Hkv, S, Sk, D, Dv,
                      sm_scale, causal, window, G, st);
  }
  if (route != kScalar || G != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(q, k, v, o, dout, lse_p, delta_p, dq, dk, dv, B, H,
                           Hkv, S, Sk, D, Dv, sm_scale, causal, window, st);
    case rt::kBF16:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse_p, delta_p, dq, dk,
                                   dv, B, H, Hkv, S, Sk, D, Dv, sm_scale,
                                   causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
