// Mamba2 SSD within a chunk: the intra-chunk quadratic form, each chunk's
// contribution to the state and its total decay.
//
// Replaces the Pallas kernel `_ssd_chunk_kernel` / `ssd_chunk` of
// src/repro/kernels/ssd_scan.py (pl.pallas_call at line 93).
//
// Computes, for x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,N),
// S = nc * L, per (b, chunk c, head h), with rows t, s of the chunk:
//   seg[t]        = sum_{u<=t} dt[u] * A[h]                  (inclusive)
//   y[t, p]       = sum_{s<=t} (C[t].B[s]) exp(seg[t]-seg[s]) dt[s] x[s, p]
//   contrib[p, n] = sum_s exp(seg[L-1]-seg[s]) dt[s] x[s, p] B[s, n]
//   total         = exp(seg[L-1])
// All four outputs are f32, in the layouts of ssd_chunk's results:
// y (B,S,H,P), contrib (B,nc,H,P,N), total (B,nc,H), seg (B,S,H).
// The cross-chunk recurrence runs in PyTorch (kernels/ref.py ssd_scan_ref).
//
// Unlike the Pallas wrapper, x is read and y written in their (B,S,H,P)
// layout (no transposed copies), and B and C are indexed by (b, chunk)
// rather than copied once per head.
//
// Because A < 0 and dt >= 0, seg falls along the chunk, so seg[t]-seg[s]
// is positive above the diagonal and its exp may overflow; the gate is
// computed only for s <= t (never inf * 0).  Padded rows (dt = 0, x = B =
// C = 0, as ops.ssd_scan pads) keep seg flat and add nothing.
//
// What bounds it on an H100: at the serving shapes (L = 128, P = 64,
// N = 64 or 128) a call moves 20-45 MB (x in, y and contrib out in f32)
// and does 2-3.4 GFLOP, so device memory bounds it (13 us at 3.35 TB/s)
// if the products ran on the tensor cores.  This first version does them
// as scalar f32 FMAs from shared memory and is bound by those.
//
// Design: one block of 256 threads per (b * nc + c, h).  dt, B and C of the
// chunk are staged in shared memory in f32 (rows padded by one float
// against bank conflicts); seg is a block scan (warp shuffles plus warp
// totals); the gated L x L score tile is built in shared memory (each
// thread a strided 8 x 8 register tile); then x replaces C in shared
// memory and the block forms y = scores @ x and contrib = (w * x)^T @ B,
// each thread again an 8 x 8 register tile.  L, N and P are at most 128,
// so shared memory is at most ~195 KB, set with cudaFuncSetAttribute.
// Tensor-core products (mma / wgmma), and C.B^T computed once per chunk
// for all heads, are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // threads form a 16 x 16 grid
constexpr int kMax = 128;               // L, N and P are at most this
constexpr int kReg = kMax / kSide;      // 8 x 8 register tile per thread

__host__ __device__ inline size_t smem_floats(int L, int N, int P) {
  const int cx = L * (N + 1) > L * P ? L * (N + 1) : L * P;
  return static_cast<size_t>(L) * (N + 1)      // B
         + cx                                  // C, then x
         + static_cast<size_t>(L) * (L + 1)    // scores
         + 3 * L                               // dt, seg, w
         + kThreads / 32;                      // warp totals of the scan
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ contrib, float* __restrict__ total,
                 float* __restrict__ seg_out, int S, int H, int P, int N,
                 int L) {
  extern __shared__ float smem[];
  const int NB = N + 1;                    // padded row of B and C
  float* B_s = smem;                       // L x NB
  float* CX_s = B_s + L * NB;              // C (L x NB), then x (L x P)
  float* S_s = CX_s + (L * NB > L * P ? L * NB : L * P);  // L x (L + 1)
  float* dt_s = S_s + L * (L + 1);
  float* seg_s = dt_s + L;
  float* w_s = seg_s + L;
  float* wsum_s = w_s + L;

  const int h = blockIdx.y;
  const int bc = blockIdx.x;               // b * nc + c
  const int nc = S / L;
  const int b = bc / nc;
  const int c = bc - b * nc;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- stage dt, B, C; seg as a block scan over the chunk ----
  const float a = A[h];
  float da = 0.f;
  if (tid < L) {
    const float d = dt[(row0 + tid) * H + h];
    dt_s[tid] = d;
    da = d * a;
  }
  for (int i = tid; i < L * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    const size_t g = (row0 + r) * N + n;
    B_s[r * NB + n] = rt::to_float(Bm[g]);
    CX_s[r * NB + n] = rt::to_float(Cm[g]);
  }
  // inclusive scan within each warp, then add the totals of earlier warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, da, o);
    if (lane >= o) da += v;
  }
  if (lane == 31) wsum_s[warp] = da;
  __syncthreads();
  if (tid < L) {
    float run = da;
    for (int w = 0; w < warp; ++w) run += wsum_s[w];
    seg_s[tid] = run;
  }
  __syncthreads();
  const float seg_last = seg_s[L - 1];
  if (tid < L) {
    w_s[tid] = expf(seg_last - seg_s[tid]) * dt_s[tid];
    seg_out[(row0 + tid) * H + h] = seg_s[tid];
  }
  if (tid == 0) total[static_cast<size_t>(bc) * H + h] = expf(seg_last);

  // ---- scores[t][s] = C[t].B[s] exp(seg[t]-seg[s]) dt[s] for s <= t ----
  {
    float acc[kReg][kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[kReg], bv[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
        const int r = ty + kSide * i;
        cv[i] = r < L ? CX_s[r * NB + n] : 0.f;
        const int s = tx + kSide * i;
        bv[i] = s < L ? B_s[s * NB + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int t = ty + kSide * i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int s = tx + kSide * j;
        if (s >= L) continue;
        S_s[t * (L + 1) + s] =
            s <= t ? acc[i][j] * expf(seg_s[t] - seg_s[s]) * dt_s[s] : 0.f;
      }
    }
  }
  __syncthreads();  // C is read no more: x takes its place

  const T* xg = x + row0 * H * P + static_cast<size_t>(h) * P;
  for (int i = tid; i < L * P; i += kThreads) {
    const int r = i / P, p = i - r * P;
    CX_s[i] = rt::to_float(xg[static_cast<size_t>(r) * H * P + p]);
  }
  __syncthreads();
  const float* X_s = CX_s;

  // ---- y[t][p] = sum_{s<=t} scores[t][s] x[s][p] ----
  {
    float acc[kReg][kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j) acc[i][j] = 0.f;
    // rows of this thread are ty, ty + 16, ...: none needs s past its last
    int t_last = ty;
    while (t_last + kSide < L) t_last += kSide;
    for (int s = 0; s <= t_last && s < L; ++s) {
      float sv[kReg], xv[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
        const int t = ty + kSide * i;
        sv[i] = t < L ? S_s[t * (L + 1) + s] : 0.f;
        const int p = tx + kSide * i;
        xv[i] = p < P ? X_s[s * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] += sv[i] * xv[j];
    }
    float* yg = y + row0 * H * P + static_cast<size_t>(h) * P;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int t = ty + kSide * i;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int p = tx + kSide * j;
        if (p < P) yg[static_cast<size_t>(t) * H * P + p] = acc[i][j];
      }
    }
  }

  // ---- contrib[p][n] = sum_s w[s] x[s][p] B[s][n] ----
  {
    float acc[kReg][kReg];
#pragma unroll
    for (int i = 0; i < kReg; ++i)
#pragma unroll
      for (int j = 0; j < kReg; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float ws = w_s[s];
      float xv[kReg], bv[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
        const int p = ty + kSide * i;
        xv[i] = p < P ? X_s[s * P + p] * ws : 0.f;
        const int n = tx + kSide * i;
        bv[i] = n < N ? B_s[s * NB + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] += xv[i] * bv[j];
    }
    float* cg = contrib + (static_cast<size_t>(bc) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int p = ty + kSide * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int n = tx + kSide * j;
        if (n < N) cg[static_cast<size_t>(p) * N + n] = acc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* contrib, void* total, void* seg,
           int Bsz, int S, int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem = smem_floats(L, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Bsz * (S / L), H);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(contrib), static_cast<float*>(total),
      static_cast<float*>(seg), S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity: S a multiple of L; L, N, P in
// 1..128; x, Bm, Cm of one dtype; dt, A and the outputs f32.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* contrib, void* total, void* seg,
                                int Bsz, int S, int H, int P, int N, int L,
                                int dtype, void* stream) {
  if (L < 1 || L > kMax || N < 1 || N > kMax || P < 1 || P > kMax ||
      S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, dt, A, Bm, Cm, y, contrib, total, seg, Bsz, S,
                           H, P, N, L, st);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, contrib, total, seg,
                                   Bsz, S, H, P, N, L, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
