// Flash-decode: one new query token per (batch, head) against a KV cache.
//
// Replaces the Pallas kernel `_decode_kernel` / `flash_decode` of
// src/repro/kernels/flash_decode.py (pl.pallas_call at line 96).
//
// Computes, for q (B,H,D), k (B,Hkv,S,D), v (B,Hkv,S,Dv), kv_len (B,):
//   o[b,h]   = softmax(q[b,h] . k[b,h/group,:n]^T * sm_scale) @ v[b,h/group,:n]
//   lse[b,h] = m + log(max(l, 1e-30))            (optional)
// with n = min(kv_len[b], S) and group = H / Hkv.  Softmax statistics and
// the accumulator are f32; the output is rounded to the input dtype.
// Keys at or past n are never read: the loop over the cache ends at n, as
// the Pallas kernel skips the blocks past kv_len.  With n == 0 the output
// is 0 and the lse -1e30 + log(1e-30), as in the Pallas kernel (its plain
// version gives the mean of v there, so kv_len == 0 is not compared).
//
// What bounds it on an H100: device memory.  Each (b, h) reads its n cached
// keys and values once and does 2 flops per element read (about 1 flop per
// byte in bf16, far below the ~295 flop/byte at which the tensor cores
// would become the limit).  So the design streams the cache once with loads
// that neighbouring threads make on neighbouring addresses, keeps q and the
// scores of one tile in shared memory and the output accumulator in
// registers, and writes nothing but the output (and lse).
//
// Design: one block of 128 threads (4 warps) per (b, h), grid (H, B).  The
// cache is walked in tiles of 128 keys.  Each warp scores keys of the tile
// (its lanes split D, a shuffle reduction sums the dot product); the block
// reduces the tile max and sum; then each thread owns up to two output
// columns dv and accumulates p_j * v[j, dv] over the tile.  The grouped
// query heads of one kv head read the same cache rows, which the L2 cache
// serves after the first read.  Splitting the sequence over several blocks
// with an lse combine, to fill all 132 SMs at small B*H, is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // keys per tile: one score per thread
constexpr int kMaxD = 256;
constexpr int kDvPerThread = kMaxD / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ lse, int H,
                    int Hkv, int S, int D, int Dv, float sm_scale) {
  __shared__ float q_s[kMaxD];
  __shared__ float p_s[kTile];
  __shared__ float red_s[kWarps];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qp = q + (static_cast<size_t>(b) * H + h) * D;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + hk) * S * Dv;
  for (int d = tid; d < D; d += kThreads) q_s[d] = rt::to_float(qp[d]);
  int n = kv_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  __syncthreads();

  float m = rt::kNegInf;
  float l = 0.f;
  float acc[kDvPerThread];
#pragma unroll
  for (int i = 0; i < kDvPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    // Scores of the tile: warp w takes keys w, w + kWarps, ...
    for (int j = warp; j < kTile; j += kWarps) {
      const int kj = k0 + j;
      float s = rt::kNegInf;
      if (kj < n) {  // the same for the whole warp
        const T* kr = kp + static_cast<size_t>(kj) * D;
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += q_s[d] * rt::to_float(kr[d]);
        s = rt::warp_sum(part) * sm_scale;
      }
      if (lane == 0) p_s[j] = s;
    }
    __syncthreads();

    // Tile max over the block; thread t holds the score of key k0 + t.
    const float s_t = p_s[tid];
    float r = rt::warp_max(s_t);
    if (lane == 0) red_s[warp] = r;
    __syncthreads();
    float tile_max = red_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tile_max = fmaxf(tile_max, red_s[w]);
    __syncthreads();

    // The tile holds at least one key below n, so m_new is finite and the
    // masked keys get p = exp(-1e30 - m_new) = 0, as in the Pallas kernel.
    const float m_new = fmaxf(m, tile_max);
    const float p = (k0 + tid < n) ? expf(s_t - m_new) : 0.f;
    p_s[tid] = p;
    r = rt::warp_sum(p);
    if (lane == 0) red_s[warp] = r;
    __syncthreads();
    float tile_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tile_sum += red_s[w];
    const float corr = expf(m - m_new);
    l = l * corr + tile_sum;
    m = m_new;

    const int kt = min(kTile, n - k0);
#pragma unroll
    for (int i = 0; i < kDvPerThread; ++i) {
      const int dv = tid + i * kThreads;
      if (dv < Dv) {
        const T* vc = vp + static_cast<size_t>(k0) * Dv + dv;
        float a = acc[i] * corr;
        for (int j = 0; j < kt; ++j)
          a += p_s[j] * rt::to_float(vc[static_cast<size_t>(j) * Dv]);
        acc[i] = a;
      }
    }
    __syncthreads();  // p_s and red_s are rewritten by the next tile
  }

  const float lc = fmaxf(l, 1e-30f);
  T* op = out + (static_cast<size_t>(b) * H + h) * Dv;
#pragma unroll
  for (int i = 0; i < kDvPerThread; ++i) {
    const int dv = tid + i * kThreads;
    if (dv < Dv) op[dv] = rt::from_float<T>(acc[i] / lc);
  }
  if (lse != nullptr && tid == 0) lse[static_cast<size_t>(b) * H + h] = m + logf(lc);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, int B, int H, int Hkv, int S, int D, int Dv,
           float sm_scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  flash_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, S, D, Dv,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity; D and Dv must be at most 256.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* out, void* lse, int B, int H,
                                   int Hkv, int S, int D, int Dv,
                                   float sm_scale, int dtype, void* stream) {
  if (D > kMaxD || Dv > kMaxD || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(q, k, v, kv_len, out, lse, B, H, Hkv, S, D, Dv,
                           sm_scale, st);
    case rt::kBF16:
      return launch<__nv_bfloat16>(q, k, v, kv_len, out, lse, B, H, Hkv, S,
                                   D, Dv, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
