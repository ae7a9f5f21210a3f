// Flash attention over a whole sequence (prefill): causal, sliding window,
// grouped kv heads, Dv != D.
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (pl.pallas_call at line 116).
//
// Computes, for q (B,H,S,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), H % Hkv == 0:
//   o[b,h,i] = sum_j p_ij v[b,h/group,j] / max(sum_j p_ij, 1e-30)
//   p_ij     = exp(s_ij - m_i), s_ij = q_i . k_j * sm_scale, where
//   s_ij = -1e30 unless j < Sk, and j <= i when causal, and i - j < window
//   when a window is given.
// The softmax runs streamed over key tiles with f32 running max, sum and
// accumulator; the output is rounded to the input dtype.  Key tiles that
// the causal or window mask hides from every row of a query tile are
// skipped, as the Pallas kernel skips its blocks; a masked key inside a
// tile that runs gets exp(-1e30 - m), exactly as there.
//
// What bounds it on an H100: at the prefill shapes of the serving slice
// (S = 100, D = 128) device memory, by a wide margin: q, k, v and o are
// read or written once (13 MB at minitron-4b, batch 4) against 0.33 GFLOP.
// For long sequences the flops grow as S^2 and the tensor cores would be
// the limit; this first version computes with scalar FMAs in f32 from
// shared memory, which is right and simple but far from the tensor-core
// rate.  wgmma, TMA and a pipelined ring of tiles come in a later change.
//
// Design: one block of 256 threads per (query tile of 16 rows, h, b),
// grid (ceil(S/16), H, B).  The block holds its q tile in shared memory
// as f32 and walks the key tiles of 64 keys that some row of it can see.
// For each key tile it stages K (rows padded to D+1 floats, so the score
// loop reads 32 distinct banks) and V in shared memory, computes the
// 16x64 scores (each thread one key column, four rows), updates the row
// statistics with one warp per row, and accumulates P @ V with each thread
// owning 4 rows x up to 4 output columns in registers.  No score matrix
// ever reaches device memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;                         // query rows per block
constexpr int kBK = 64;                         // keys per tile
constexpr int kMaxD = 256;
constexpr int kRowGroups = kThreads / kBK;      // 4
constexpr int kRowsPerThread = kBQ / kRowGroups;  // 4
constexpr int kColSlots = kMaxD / 64;           // output columns per thread
static_assert(kBK == 64, "row statistics take two keys per lane");
static_assert(kThreads / 64 == kRowGroups, "P@V and scores share rows");

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * Dv + kBQ * kBK + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int S, int Sk, int D, int Dv, float sm_scale,
                       int causal, int window) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ x D
  float* k_s = q_s + kBQ * D;         // kBK x (D + 1)
  float* v_s = k_s + kBK * (D + 1);   // kBK x Dv
  float* s_s = v_s + kBK * Dv;        // kBQ x kBK scores, then p
  float* m_s = s_s + kBQ * kBK;       // running max per row
  float* l_s = m_s + kBQ;             // running sum per row
  float* c_s = l_s + kBQ;             // this tile's correction per row

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qp = q + (static_cast<size_t>(b) * H + h) * S * D;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;
  T* op = out + (static_cast<size_t>(b) * H + h) * S * Dv;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    q_s[i] = (q0 + r < S) ? rt::to_float(qp[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = rt::kNegInf;
    l_s[tid] = 0.f;
  }

  // Scores: this thread's key column and first row (rows sr + 4i).
  const int sc = tid % kBK;
  const int sr = tid / kBK;
  // P @ V: this thread's first output column (pc + 64j) and first row.
  const int pc = tid % 64;
  const int pr = tid / 64;
  float acc[kRowsPerThread][kColSlots];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColSlots; ++j) acc[i][j] = 0.f;

  // Key range that some row of this tile can see.
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / kBK) * kBK;
  }
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      k_s[r * (D + 1) + d] =
          (k0 + r < Sk) ? rt::to_float(kp[static_cast<size_t>(k0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv;
      const int d = i - r * Dv;
      v_s[i] = (k0 + r < Sk) ? rt::to_float(vp[static_cast<size_t>(k0 + r) * Dv + d]) : 0.f;
    }
    __syncthreads();

    {
      float s[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
      const float* kr = k_s + sc * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          s[i] += q_s[(sr + kRowGroups * i) * D + d] * kv;
      }
      const int kj = k0 + sc;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = sr + kRowGroups * i;
        const int qi = q0 + r;
        bool ok = kj < Sk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && qi - kj < window;
        s_s[r * kBK + sc] = ok ? s[i] * sm_scale : rt::kNegInf;
      }
    }
    __syncthreads();

    // Row statistics: one warp per row, two keys per lane.
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = s_s + r * kBK;
      const float a0 = row[lane];
      const float a1 = row[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, rt::warp_max(fmaxf(a0, a1)));
      const float p0 = expf(a0 - m_new);
      const float p1 = expf(a1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float corr = c_s[pr + kRowGroups * i];
#pragma unroll
      for (int j = 0; j < kColSlots; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float vv[kColSlots];
#pragma unroll
      for (int j = 0; j < kColSlots; ++j) {
        const int dv = pc + 64 * j;
        vv[j] = dv < Dv ? v_s[c * Dv + dv] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float p = s_s[(pr + kRowGroups * i) * kBK + c];
#pragma unroll
        for (int j = 0; j < kColSlots; ++j) acc[i][j] += p * vv[j];
      }
    }
    __syncthreads();  // k_s, v_s and s_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = pr + kRowGroups * i;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float lc = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kColSlots; ++j) {
      const int dv = pc + 64 * j;
      if (dv < Dv) op[static_cast<size_t>(qi) * Dv + dv] = rt::from_float<T>(acc[i][j] / lc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int Sk, int D, int Dv, float sm_scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, S, Sk, D, Dv,
      sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity; D and Dv must be at most 256, and
// window <= 0 means no window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int S, int Sk, int D, int Dv,
                                      float sm_scale, int causal, int window,
                                      int dtype, void* stream) {
  if (D > kMaxD || Dv > kMaxD || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(q, k, v, out, B, H, Hkv, S, Sk, D, Dv, sm_scale,
                           causal, window, st);
    case rt::kBF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, Sk, D, Dv,
                                   sm_scale, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
