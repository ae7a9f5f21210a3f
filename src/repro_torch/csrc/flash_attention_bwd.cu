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
// dK and dV sum over the query heads of the kv head's group.  Everything is
// computed in float32 from inputs of either dtype; the outputs are rounded
// to the inputs' dtype.
//
// Design: three launches, no atomics, so the result is deterministic (a
// restarted run reproduces its bits).
//   1. `delta_kernel`: one warp per row, delta = rowsum(do o).
//   2. `dkdv_kernel`: one block per (b, kv head, tile of 32 keys).  K and V
//      of the tile stay in shared memory; the block walks the group's query
//      heads and the query tiles of 32 rows that the mask admits (causal:
//      from the tile holding the first key on; window: up to the last key
//      + window - 1), recomputes P and dS for each, and accumulates dV and
//      dK in registers (a warp owns 4 key rows, a lane its columns).
//   3. `dq_kernel`: one block per (b, head, tile of 32 query rows), Q, dO,
//      lse and delta in shared memory; it walks the key tiles the mask
//      admits and accumulates dQ in registers the same way.
// Both recompute P and dS of a (query tile, key tile) pair with the same
// routine: each thread scores one query row against four key rows with
// scalar f32 FMAs from shared memory (rows padded by one float, so the
// lanes' rows fall in distinct banks).
//
// What bounds it on an H100: at the training shape (minitron-4b: 8 x 32
// heads x 128 positions x head dim 128, causal) the backward does 2.5x the
// forward's operations, 2.7 GFLOP a layer, 2.7 us on the bf16 tensor
// cores; its inputs and outputs are 67 MB, 20 us at 3.35 TB/s, so bytes
// bound it.  This first version runs on the scalar f32 cores (67 TFLOP/s
// peak: 40 us for those operations) and is held back further by
// shared-memory loads (about one load per two FMAs), so it is bound by
// operations on the wrong unit; the `mma.sync` fragments of K2's forward
// (common.cuh) are the next step.

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
// float32 (B,H,S).  D and Dv at most 256; window <= 0 means no window.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int Sk, int D, int Dv,
    float sm_scale, int causal, int window, int dtype, void* stream) {
  if (D > 256 || Dv > 256 || D < 1 || Dv < 1 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_p = static_cast<const float*>(lse);
  float* delta_p = static_cast<float*>(delta);
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
