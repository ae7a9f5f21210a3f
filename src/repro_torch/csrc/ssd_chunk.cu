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
// N = 64 or 128, bf16 in) a call moves 20-42 MB (x in, y and contrib out
// in f32) and does 1.3-2.7 GFLOP, so device memory bounds it (6.5-13 us
// at 3.35 TB/s) once the products run on the tensor cores.
//
// Each dtype has one body, chosen by the launch function:
//
// bfloat16 (every serving path): `ssd_chunk_bf16_kernel`, on the tensor
// cores (`mma.sync.m16n8k16` bf16 -> f32).
//   * C B^T does not depend on the head (B and C are (B,S,N)), so a block
//     takes (b * nc + c, a group of G heads), G from the wrapper's plan
//     (kernels/ssd_scan.py head_group: the largest G whose grid still
//     makes 1.5 waves of the 132 SMs; 3 at zamba2's shape, 1 at
//     mamba2's), and computes C B^T once: each of 8 warps its 16 rows t
//     and the keys s <= t, kept in registers as mma accumulators.
//   * Per head: seg is a block scan of dt * A[h]; the gate
//     exp(seg[t] - seg[s]) dt[s] is applied to the C B^T fragments in
//     registers, only for s <= t, and the gated scores become the A
//     fragments of y = scores x, as K2 turns S into P; the key tiles above
//     a warp's diagonal are skipped; y takes up to 64 columns of P a pass
//     (one pass at P = 64), so the gate's exps are computed once a head.
//     contrib = (w x)^T B takes A from `ldmatrix.trans` of x's (s, p)
//     rows scaled by w in registers.
//   * The two f32 operands (gated scores, w x) are split into hi + lo
//     bf16 and each product runs twice: rounding them to bf16 once would
//     cost ~2^-9 per term, beyond the f32 outputs' atol 2e-3 / rtol 1e-3.
//     x, B and C are bf16 already, so C B^T has exact inputs.
//   * Staging: C and B of the chunk, and x of the next head while this
//     head computes, with 16-byte `cp.async` (element loads where a row
//     is not 16-byte aligned), rows padded by 16 bytes; N, P and L are
//     zero-filled to multiples of 16 in shared memory.  ~108 KB at
//     N = 128, 74 KB at N = 64: two or three blocks an SM.
//   What is left: the y products of a warp grow with its rows (warp 7
//   runs 8 key tiles, warp 0 one); a group's heads run one after another
//   in a block (x of the next is prefetched); ptxas spills ~130 bytes at
//   the two-blocks-an-SM register cap; `wgmma` would pay off only at
//   chunks far above 128.
//
// float32 (the f32 tests): `ssd_chunk_kernel`, the first version: one
// block of 256 threads per (b * nc + c, h).  dt, B and C of the chunk are
// staged in shared memory in f32 (rows padded by one float against bank
// conflicts); seg is a block scan (warp shuffles plus warp totals); the
// gated L x L score tile is built in shared memory (each thread a strided
// 8 x 8 register tile); then x replaces C in shared memory and the block
// forms y = scores @ x and contrib = (w * x)^T @ B, each thread again an
// 8 x 8 register tile of scalar f32 FMAs.  Shared memory is at most ~195
// KB, set with cudaFuncSetAttribute.

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

// --------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using rt::cp_async;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::stage_bf16;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma_bf16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kYCols = 64;   // y columns a warp accumulates per pass
constexpr int kCTiles = 4;   // contrib n-tiles a warp accumulates per pass

// The bf16 body's shared-memory tiles: L, N and P rounded up to 16 (zero
// filled), rows padded by 16 bytes for conflict-free `ldmatrix`.
struct TcDims {
  int LP, NP, PP, LDN, LDP;
  __host__ __device__ TcDims(int L, int N, int P)
      : LP((L + 15) / 16 * 16), NP((N + 15) / 16 * 16),
        PP((P + 15) / 16 * 16), LDN(NP + 8), LDP(PP + 8) {}
  // C and B, two x buffers, then dt, seg, w and the scan's warp totals
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(bf16) * (2 * static_cast<size_t>(LP) * LDN +
                           2 * static_cast<size_t>(LP) * LDP) +
           sizeof(float) * (3 * LP + kTcWarps);
  }
};

// (v0, v1) as bf16 pairs hi + lo: hi = bf16(v), lo = bf16(v - hi), so
// that hi + lo carries v to about 2^-16 of itself.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h),
                                                 v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One block per (b * nc + c, group of G heads); see the header.
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_chunk_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, float* __restrict__ y,
                      float* __restrict__ contrib, float* __restrict__ total,
                      float* __restrict__ seg_out, int S, int H, int P,
                      int N, int L, int G, int vec_bc, int vec_x) {
  const TcDims d(L, N, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* C_s = reinterpret_cast<bf16*>(smem_raw);  // LP x LDN
  bf16* B_s = C_s + d.LP * d.LDN;                 // LP x LDN
  bf16* X_s = B_s + d.LP * d.LDN;                 // 2 x LP x LDP
  float* dt_s = reinterpret_cast<float*>(X_s + 2 * d.LP * d.LDP);
  float* seg_s = dt_s + d.LP;
  float* w_s = seg_s + d.LP;
  float* wsum_s = w_s + d.LP;

  const int bc = blockIdx.x;  // b * nc + c
  const int nc = S / L;
  const int b = bc / nc;
  const int c = bc - b * nc;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const int h0 = blockIdx.y * G;
  const int hn = min(G, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tq = lane & 3;   // fragment column pair
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  const size_t xrow = static_cast<size_t>(H) * P;  // row stride of x and y
  const size_t xbuf = static_cast<size_t>(d.LP) * d.LDP;

  stage_bf16(C_s, Cm + row0 * N, L, N, N, d.LP, d.NP, d.LDN, vec_bc);
  stage_bf16(B_s, Bm + row0 * N, L, N, N, d.LP, d.NP, d.LDN, vec_bc);
  stage_bf16(X_s, x + row0 * xrow + static_cast<size_t>(h0) * P, L, P, xrow,
             d.LP, d.PP, d.LDP, vec_x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T, once for all heads of the block: this warp's 16 rows t0.. and
  // the keys s <= t0 + 15 (n-tiles 0 .. 2 warp + 1), kept in registers.
  const int t0 = 16 * warp;
  const bool has_rows = t0 < L;
  float cb[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
  if (has_rows) {
    for (int kk = 0; kk < d.NP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, C_s + (t0 + lm_row + (lm_mat & 1) * 8) * d.LDN +
                         kk * 16 + (lm_mat >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (jp <= warp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, B_s + (jp * 16 + lm_row + (lm_mat >> 1) * 8) * d.LDN +
                              kk * 16 + (lm_mat & 1) * 8);
          mma_bf16(cb[2 * jp], a, bk[0], bk[1]);
          mma_bf16(cb[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

  for (int gi = 0; gi < hn; ++gi) {
    const int h = h0 + gi;
    const bf16* xs = X_s + (gi & 1) * xbuf;
    if (gi + 1 < hn)  // the next head's x, while this head computes
      stage_bf16(X_s + ((gi + 1) & 1) * xbuf,
                 x + row0 * xrow + static_cast<size_t>(h + 1) * P, L, P,
                 xrow, d.LP, d.PP, d.LDP, vec_x);
    cp_async_commit();

    // seg: inclusive scan of dt * A[h] over the chunk (warp scans, then
    // the totals of earlier warps); w[s] = exp(seg[L-1] - seg[s]) dt[s]
    const float dtv = tid < L ? dt[(row0 + tid) * H + h] : 0.f;
    float da = dtv * A[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, da, o);
      if (lane >= o) da += v;
    }
    if (lane == 31) wsum_s[warp] = da;
    __syncthreads();
    if (tid < d.LP) {
      float run = da;
      for (int w = 0; w < warp; ++w) run += wsum_s[w];
      seg_s[tid] = run;
      dt_s[tid] = dtv;
    }
    __syncthreads();
    const float seg_last = seg_s[L - 1];
    if (tid < d.LP)
      w_s[tid] = tid < L ? expf(seg_last - seg_s[tid]) * dt_s[tid] : 0.f;
    if (tid < L) seg_out[(row0 + tid) * H + h] = seg_s[tid];
    if (tid == 0) total[static_cast<size_t>(bc) * H + h] = expf(seg_last);
    cp_async_wait<1>();
    __syncthreads();  // x of head h and w have landed

    // y[t, p] = sum_{s<=t} C[t].B[s] exp(seg[t]-seg[s]) dt[s] x[s, p]: the
    // gated scores from the C B^T fragments, as hi + lo A fragments, and
    // x's B fragments from ldmatrix.trans of its (s, p) rows.
    if (has_rows) {
      const float seg_t[2] = {seg_s[t0 + g], seg_s[t0 + g + 8]};
      float* yh = y + row0 * xrow + static_cast<size_t>(h) * P;
      for (int pc = 0; pc < d.PP; pc += kYCols) {
        float acc[kYCols / 8][4];
#pragma unroll
        for (int n = 0; n < kYCols / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk > warp) continue;
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const int s = 8 * j + 2 * tq;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int t = t0 + g + 8 * r;
              const float v0 =
                  s <= t ? cb[j][2 * r] * expf(seg_t[r] - seg_s[s]) * dt_s[s]
                         : 0.f;
              const float v1 = s + 1 <= t ? cb[j][2 * r + 1] *
                                                expf(seg_t[r] - seg_s[s + 1]) *
                                                dt_s[s + 1]
                                          : 0.f;
              split_pair(v0, v1, ahi[jj * 2 + r], alo[jj * 2 + r]);
            }
          }
#pragma unroll
          for (int np = 0; np < kYCols / 16; ++np) {
            const int col = pc + 16 * np;
            if (col < d.PP) {
              uint32_t bx[4];
              ldmatrix_x4_trans(bx, xs + (16 * kk + lm_row + (lm_mat & 1) * 8) *
                                             d.LDP +
                                        col + (lm_mat >> 1) * 8);
              mma_bf16(acc[2 * np], ahi, bx[0], bx[1]);
              mma_bf16(acc[2 * np], alo, bx[0], bx[1]);
              mma_bf16(acc[2 * np + 1], ahi, bx[2], bx[3]);
              mma_bf16(acc[2 * np + 1], alo, bx[2], bx[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kYCols / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = t0 + g + 8 * r;
            const int p = pc + 8 * n + 2 * tq;
            if (t >= L || p >= P) continue;
            float* dst = yh + static_cast<size_t>(t) * xrow + p;
            if (p + 1 < P && (P & 1) == 0) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
            } else {
              dst[0] = acc[n][2 * r];
              if (p + 1 < P) dst[1] = acc[n][2 * r + 1];
            }
          }
      }
    }

    // contrib[p, n] = sum_s (w[s] x[s, p]) B[s, n]: A = (w x)^T from
    // ldmatrix.trans of x, scaled and split hi + lo in registers; B's
    // fragments from ldmatrix.trans of its (s, n) rows.  Warps split the
    // p-tiles, then the n-tiles of each.
    {
      const int PT = d.PP / 16;
      const int NT = d.NP / 8;
      const int wpp = kTcWarps / PT;  // warps per p-tile
      const int pt = warp / wpp;
      const int part = warp - pt * wpp;
      const int per = (NT + wpp - 1) / wpp;
      const int nt0 = part * per;
      const int nt1 = min(NT, nt0 + per);
      float* ch = contrib + (static_cast<size_t>(bc) * H + h) * P * N;
      for (int nb = nt0; pt < PT && nb < nt1; nb += kCTiles) {
        float acc[kCTiles][4];
#pragma unroll
        for (int n = 0; n < kCTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        for (int kk = 0; kk < d.LP / 16; ++kk) {
          uint32_t ax[4], ahi[4], alo[4];
          ldmatrix_x4_trans(ax, xs + (16 * kk + (lm_mat >> 1) * 8 + lm_row) *
                                         d.LDP +
                                    16 * pt + (lm_mat & 1) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = 16 * kk + (i >> 1) * 8 + 2 * tq;
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(&ax[i]);
            split_pair(__low2float(x2) * w_s[s], __high2float(x2) * w_s[s + 1],
                       ahi[i], alo[i]);
          }
#pragma unroll
          for (int q = 0; q < kCTiles; q += 2) {
            const int n = nb + q;
            if (n < nt1) {
              uint32_t bb[4];
              ldmatrix_x4_trans(
                  bb, B_s + (16 * kk + lm_row + (lm_mat & 1) * 8) * d.LDN +
                          8 * n + (lm_mat >> 1) * 8);
              mma_bf16(acc[q], ahi, bb[0], bb[1]);
              mma_bf16(acc[q], alo, bb[0], bb[1]);
              if (n + 1 < nt1) {
                mma_bf16(acc[q + 1], ahi, bb[2], bb[3]);
                mma_bf16(acc[q + 1], alo, bb[2], bb[3]);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kCTiles; ++q)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = 16 * pt + g + 8 * r;
            const int n = 8 * (nb + q) + 2 * tq;
            if (nb + q >= nt1 || p >= P || n >= N) continue;
            float* dst = ch + static_cast<size_t>(p) * N + n;
            if (n + 1 < N && (N & 1) == 0) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
            } else {
              dst[0] = acc[q][2 * r];
              if (n + 1 < N) dst[1] = acc[q][2 * r + 1];
            }
          }
      }
    }
    __syncthreads();  // x, dt, seg and w are rewritten for the next head
  }
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* contrib, void* total,
                void* seg, int Bsz, int S, int H, int P, int N, int L, int G,
                cudaStream_t stream) {
  if (G < 1 || (H + G - 1) / G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = TcDims(L, N, P).smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // the largest shared-memory carveout, so that two or three blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ssd_chunk_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bc_addr =
      reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm);
  const int vec_bc = N % 8 == 0 && bc_addr % 16 == 0;
  const int vec_x = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(Bsz * (S / L), (H + G - 1) / G);
  ssd_chunk_bf16_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(contrib), static_cast<float*>(total),
      static_cast<float*>(seg), S, H, P, N, L, G, vec_bc, vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity: S a multiple of L; L, N, P in
// 1..128; x, Bm, Cm of one dtype; dt, A and the outputs f32.  `group` is
// the number of heads a block of the bf16 body takes (kernels/ssd_scan.py
// head_group); the f32 body takes one head a block and ignores it.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* contrib, void* total, void* seg,
                                int Bsz, int S, int H, int P, int N, int L,
                                int group, int dtype, void* stream) {
  if (L < 1 || L > kMax || N < 1 || N > kMax || P < 1 || P > kMax ||
      S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, dt, A, Bm, Cm, y, contrib, total, seg, Bsz, S,
                           H, P, N, L, st);
    case rt::kBF16:
      return launch_bf16(x, dt, A, Bm, Cm, y, contrib, total, seg, Bsz, S, H,
                         P, N, L, group, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
