// The backward of the Mamba2 SSD within a chunk (K4b): the gradients of
// ssd_chunk's four outputs (y_intra, contrib, total, seg) with respect to
// x, dt, A, Bm and Cm.
//
// The JAX package has no kernel to replace here: its models differentiate
// ssd_scan_ref (src/repro/kernels/ref.py:331-391) by autodiff.  This is the
// backward of K4 (csrc/ssd_chunk.cu, which replaces the pl.pallas_call of
// src/repro/kernels/ssd_scan.py:93); its plain version is
// kernels/ref.py ssd_chunk_bwd_ref.
//
// Per (b, chunk c, head h), rows t, s of the chunk, E[t,s] = exp(seg[t] -
// seg[s]) for s <= t (else 0), G[t,s] = (C[t].B[s]) E[t,s] dt[s] and
// W[s] = exp(seg[L-1] - seg[s]) dt[s], with cotangents dy, dcontrib (dK),
// dtotal and dseg:
//   dG[t,s] = dy[t] . x[s]                          (s <= t)
//   dx[s]   = dt[s] (sum_t C B^T E[t,s] dy[t] + exp(seg[L-1]-seg[s]) Q[s]),
//             Q[s,p] = sum_n B[s,n] dK[p,n]
//   dCB     = dG E dt;  dC = dCB B;  dB = dCB^T C + W[s] x[s]^T dK
//   seg's cotangent gs = dseg + rowsum(R) - colsum(R) - dW W, R = dG G,
//             dW[s] = x[s] . Q[s], plus sum_s dW W + dtotal total at L-1
//   ddt[u]  = sum_t dG C B^T E[t,u] + dW[u] exp(seg[L-1]-seg[u]) + A rc[u],
//             rc the reverse cumulative sum of gs;  dA = sum dt rc.
// seg is the forward's own output, read, not recomputed.
//
// Two launches, no atomics, so a rerun gives the same bits:
//   * ssd_chunk_bwd_kernel, one block of 256 threads per (b * nc + c, h):
//     dx and ddt, and this head's partials of dB, dC (summed over the
//     heads) and of dA (summed over batch and chunks), into a scratch
//     buffer;
//   * ssd_chunk_bwd_reduce_kernel sums the partials in a fixed order
//     (heads 0..H-1, then (b, c) pairs in order).
//
// The first version, scalar f32 FMAs: every product of the chunk (C B^T,
// Q, the two dx products, dG, dC, the two dB products) runs through one
// block-level routine, `product`, in which each thread holds an 8 x 8
// register tile (rows ty + 16 i, columns tx + 16 j of a 16 x 16 thread
// grid) and the operands are staged through shared memory 16 contraction
// columns at a time, read from wherever they lie (global memory or the
// block's L x L tile) with any row and column stride.  Shared memory: the
// L x (L + 1) f32 tile (C B^T E, then dCB), the two staging buffers and the
// per-row vectors, ~103 KB at L = 128, whatever N and P; so no operand of
// size L x N or L x P has to fit beside it.  The exponent above the
// diagonal is positive and never reaches exp: those entries are set to 0
// without it.  Row sums go through half-warp shuffles (the 16 threads of a
// row are one half-warp), column sums through per-ty partials in shared
// memory added in order.  What is left: the products run on the FP32 pipe,
// not the tensor cores; the L x L products at the forward's shapes would
// take mma.sync as K4's bf16 body does.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // threads form a 16 x 16 grid
constexpr int kMax = 128;               // L, N and P are at most this
constexpr int kReg = kMax / kSide;      // 8 x 8 register tile per thread
constexpr int kK = 16;                  // contraction columns staged a pass
constexpr int kKP = kK + 1;             // padded staging row

__host__ __device__ inline size_t smem_floats(int L) {
  return static_cast<size_t>(L) * (L + 1)        // the L x L tile
         + 2 * kMax * kKP                        // staging of a and b
         + 7 * static_cast<size_t>(L)            // per-row vectors
         + 2 * kSide * static_cast<size_t>(L);   // column-sum partials
}

// A read-only operand: element (r, k) at p[r * rs + k * ks].
template <typename T>
struct Mat {
  const T* p;
  long long rs, ks;
  __device__ __forceinline__ float at(int r, int k) const {
    return rt::to_float(p[r * rs + k * ks]);
  }
};

template <typename T>
__device__ __forceinline__ Mat<T> mat(const T* p, long long rs,
                                      long long ks) {
  return Mat<T>{p, rs, ks};
}

__device__ __forceinline__ void zero(float (&acc)[kReg][kReg]) {
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a(ty + 16 i, k) * b(tx + 16 j, k), a with R rows
// and b with C rows (the rest read as 0).  Called by the whole block; it
// starts and ends with a barrier, so it may read the L x L tile that the
// block wrote before the call.
template <typename TA, typename TB>
__device__ void product(float (&acc)[kReg][kReg], Mat<TA> a, int R,
                        Mat<TB> b, int C, int K, float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  for (int k0 = 0; k0 < K; k0 += kK) {
    const int kn = min(kK, K - k0);
    __syncthreads();
    for (int i = tid; i < kMax * kK; i += kThreads) {
      const int r = i / kK, k = i - r * kK;
      As[r * kKP + k] = (r < R && k < kn) ? a.at(r, k0 + k) : 0.f;
      Bs[r * kKP + k] = (r < C && k < kn) ? b.at(r, k0 + k) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) {
      float av[kReg], bv[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
        av[i] = As[(ty + kSide * i) * kKP + k];
        bv[i] = Bs[(tx + kSide * i) * kKP + k];
      }
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int j = 0; j < kReg; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
  __syncthreads();
}

// The sum over the 16 threads of a half-warp (one row of the thread grid).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kSide / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ seg,
                     const float* __restrict__ dy,
                     const float* __restrict__ dcontrib,
                     const float* __restrict__ dtotal,
                     const float* __restrict__ dseg, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dA_part,
                     float* __restrict__ dB_part,
                     float* __restrict__ dC_part, int S, int H, int P,
                     int N, int L) {
  extern __shared__ float smem[];
  const int LP = L + 1;
  float* T_s = smem;                       // L x LP: C B^T E, then dCB
  float* As = T_s + L * LP;
  float* Bs = As + kMax * kKP;
  float* dt_s = Bs + kMax * kKP;
  float* seg_s = dt_s + L;
  float* ew_s = seg_s + L;                 // exp(seg[L-1] - seg[s])
  float* dW_s = ew_s + L;                  // x[s] . Q[s]
  float* rowR_s = dW_s + L;                // row sums of R
  float* gs_s = rowR_s + L;                // seg's cotangent, then rc
  float* colD_s = gs_s + L;                // sum_t dG C B^T E (ddt part)
  float* pR_s = colD_s + L;                // kSide x L partials of colsum R
  float* pD_s = pR_s + kSide * L;          // kSide x L partials of colD

  const int h = blockIdx.y;
  const int bc = blockIdx.x;               // b * nc + c
  const size_t row0 = static_cast<size_t>(bc) * L;  // b * S + c * L
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const long long HP = static_cast<long long>(H) * P;

  const T* xg = x + row0 * HP + static_cast<size_t>(h) * P;
  const float* dyg = dy + row0 * HP + static_cast<size_t>(h) * P;
  const T* Bg = Bm + row0 * N;
  const T* Cg = Cm + row0 * N;
  const float* dKg = dcontrib + (static_cast<size_t>(bc) * H + h) * P * N;
  float* dxg = dx + row0 * HP + static_cast<size_t>(h) * P;

  if (tid < L) {
    dt_s[tid] = dt[(row0 + tid) * H + h];
    seg_s[tid] = seg[(row0 + tid) * H + h];
  }
  __syncthreads();
  const float seg_last = seg_s[L - 1];
  if (tid < L) ew_s[tid] = expf(seg_last - seg_s[tid]);

  float acc[kReg][kReg];

  // ---- Q[s,p] = sum_n B[s,n] dK[p,n]; dW = rowsum(x Q); the dx part ----
  zero(acc);
  product(acc, mat(Bg, N, 1), L, mat(dKg, N, 1), P, N, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int s = ty + kSide * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int p = tx + kSide * j;
      if (s < L && p < P) {
        part += rt::to_float(xg[s * HP + p]) * acc[i][j];
        dxg[s * HP + p] = ew_s[s] * acc[i][j];   // read back below
      }
    }
    part = row_sum(part);
    if (tx == 0 && s < L) dW_s[s] = part;
  }

  // ---- the tile: C B^T E[t,s] for s <= t, else 0 ----
  zero(acc);
  product(acc, mat(Cg, N, 1), L, mat(Bg, N, 1), L, N, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int t = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int s = tx + kSide * j;
      if (t < L && s < L)
        T_s[t * LP + s] =
            s <= t ? acc[i][j] * expf(seg_s[t] - seg_s[s]) : 0.f;
    }
  }

  // ---- dx[s,p] = dt[s] (sum_t tile[t,s] dy[t,p] + ew[s] Q[s,p]) ----
  zero(acc);
  product(acc, mat<float>(T_s, 1, LP), L, mat(dyg, 1, HP), P, L, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int s = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int p = tx + kSide * j;
      if (s < L && p < P)
        dxg[s * HP + p] = dt_s[s] * (acc[i][j] + dxg[s * HP + p]);
    }
  }

  // ---- dG = dy x^T; R = dG G; the tile becomes dCB = dG E dt ----
  zero(acc);
  product(acc, mat(dyg, HP, 1), L, mat(xg, HP, 1), L, P, As, Bs);
  {
    float colR[kReg], colD[kReg];
#pragma unroll
    for (int j = 0; j < kReg; ++j) colR[j] = colD[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int t = ty + kSide * i;
      float rowR = 0.f;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int s = tx + kSide * j;
        if (t < L && s <= t) {
          const float dg = acc[i][j];
          const float cbe = T_s[t * LP + s];
          const float r = dg * cbe * dt_s[s];
          rowR += r;
          colR[j] += r;
          colD[j] += dg * cbe;
          T_s[t * LP + s] = dg * expf(seg_s[t] - seg_s[s]) * dt_s[s];
        }
      }
      rowR = row_sum(rowR);
      if (tx == 0 && t < L) rowR_s[t] = rowR;
    }
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int s = tx + kSide * j;
      if (s < L) {
        pR_s[ty * L + s] = colR[j];
        pD_s[ty * L + s] = colD[j];
      }
    }
  }
  __syncthreads();
  if (tid < L) {
    float r = 0.f, d = 0.f;
    for (int k = 0; k < kSide; ++k) {
      r += pR_s[k * L + tid];
      d += pD_s[k * L + tid];
    }
    gs_s[tid] = dseg[(row0 + tid) * H + h] + rowR_s[tid] - r -
                dW_s[tid] * ew_s[tid] * dt_s[tid];
    colD_s[tid] = d;
  }

  // ---- dC[t,n] = sum_s dCB[t,s] B[s,n], this head's partial ----
  const size_t part0 = (static_cast<size_t>(bc) * H + h) * L * N;
  zero(acc);
  product(acc, mat<float>(T_s, LP, 1), L, mat(Bg, 1, N), N, L, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int t = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int n = tx + kSide * j;
      if (t < L && n < N) dC_part[part0 + t * N + n] = acc[i][j];
    }
  }

  // ---- dB[s,n] = W[s] sum_p x[s,p] dK[p,n] + sum_t dCB[t,s] C[t,n] ----
  zero(acc);
  product(acc, mat(xg, HP, 1), L, mat(dKg, 1, N), N, P, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int s = ty + kSide * i;
    const float w = s < L ? ew_s[s] * dt_s[s] : 0.f;
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] *= w;
  }
  product(acc, mat<float>(T_s, 1, LP), L, mat(Cg, 1, N), N, L, As, Bs);
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int s = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      const int n = tx + kSide * j;
      if (s < L && n < N) dB_part[part0 + s * N + n] = acc[i][j];
    }
  }

  // ---- seg's cotangent at L-1, the reverse cumulative sum, ddt, dA ----
  if (tid == 0) {
    float wsum = 0.f;
    for (int s = 0; s < L; ++s) wsum += dW_s[s] * ew_s[s] * dt_s[s];
    gs_s[L - 1] += wsum + dtotal[static_cast<size_t>(bc) * H + h] *
                              expf(seg_last);
    float rc = 0.f, da = 0.f;
    for (int u = L - 1; u >= 0; --u) {
      rc += gs_s[u];
      gs_s[u] = rc;
      da += dt_s[u] * rc;
    }
    dA_part[static_cast<size_t>(bc) * H + h] = da;
  }
  __syncthreads();
  if (tid < L)
    ddt[(row0 + tid) * H + h] =
        colD_s[tid] + dW_s[tid] * ew_s[tid] + A[h] * gs_s[tid];
}

// dB, dC (rows of the whole batch): the partials summed over heads 0..H-1;
// dA: the (b, c) partials summed in order.
__global__ void ssd_chunk_bwd_reduce_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    const float* __restrict__ dA_part, float* __restrict__ dB,
    float* __restrict__ dC, float* __restrict__ dA, int BC, int H, int L,
    int N) {
  const size_t rows = static_cast<size_t>(BC) * L * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < rows) {
    const size_t LN = static_cast<size_t>(L) * N;
    const size_t bc = i / LN, e = i - bc * LN;
    const float* pb = dB_part + bc * H * LN + e;
    const float* pc = dC_part + bc * H * LN + e;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * LN];
      sc += pc[h * LN];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < rows + H) {
    const int h = static_cast<int>(i - rows);
    float s = 0.f;
    for (int bc = 0; bc < BC; ++bc) s += dA_part[static_cast<size_t>(bc) * H + h];
    dA[h] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* seg, const void* dy,
           const void* dcontrib, const void* dtotal, const void* dseg,
           void* dx, void* ddt, void* dA, void* dB, void* dC, void* scratch,
           int Bsz, int S, int H, int P, int N, int L, cudaStream_t stream) {
  const int BC = Bsz * (S / L);
  if (H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t part = static_cast<size_t>(BC) * H * L * N;
  float* dB_part = static_cast<float*>(scratch);
  float* dC_part = dB_part + part;
  float* dA_part = dC_part + part;
  ssd_chunk_bwd_kernel<T><<<dim3(BC, H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(seg),
      static_cast<const float*>(dy), static_cast<const float*>(dcontrib),
      static_cast<const float*>(dtotal), static_cast<const float*>(dseg),
      static_cast<float*>(dx), static_cast<float*>(ddt), dA_part, dB_part,
      dC_part, S, H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(BC) * L * N + H;
  const int threads = 256;
  ssd_chunk_bwd_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                      threads),
                                threads, 0, stream>>>(
      dB_part, dC_part, dA_part, static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA), BC, H, L, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launches (0 on success).  The
// caller checks shapes, dtypes and contiguity: S a multiple of L; L, N, P
// in 1..128; x, Bm, Cm of one dtype (`dtype`); every other input and every
// output f32; `scratch` holds 2 * (B * S/L) * H * L * N + (B * S/L) * H
// floats.  Outputs: dx (B,S,H,P), ddt (B,S,H), dA (H,), dB and dC (B,S,N).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* seg, const void* dy, const void* dcontrib,
    const void* dtotal, const void* dseg, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* scratch, int Bsz, int S, int H, int P, int N,
    int L, int dtype, void* stream) {
  if (L < 1 || L > kMax || N < 1 || N > kMax || P < 1 || P > kMax ||
      Bsz < 1 || H < 1 || S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg,
                           dx, ddt, dA, dB, dC, scratch, Bsz, S, H, P, N, L,
                           st);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, seg, dy, dcontrib,
                                   dtotal, dseg, dx, ddt, dA, dB, dC, scratch,
                                   Bsz, S, H, P, N, L, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
