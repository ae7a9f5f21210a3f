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
// Two launches, no atomics, so a rerun gives the same bits.  Each dtype
// has its body, chosen by the launch function.
//
// What bounds it on an H100: at the training shapes (x (8,128,32,64),
// N 128, and (8,128,80,64), N 64, L 128, bf16 x, B, C) a call must move
// 31 and 65 MB (dy, dcontrib and dx in f32): 9 and 19 us at 3.35 TB/s.
// Nearly every product has a float32 operand; at float32 accuracy
// (3xTF32, two TF32 products where the other operand is bf16) they take
// 3.6 and 6.1 GFLOP of TF32 work, 7 and 12 us at 495 TFLOP/s: bytes bound
// it, once the products run on the tensor cores.
//
// bfloat16 (every training path): three launches.
// `ssd_chunk_bwd_bf16_kernel`, one block of 16 warps per (b * nc + c, a
// group of heads), G heads from the wrapper (kernels/ssd_scan_bwd.py
// bwd_head_group: the largest group up to 8 whose grid still makes 1.5
// waves of the 132 SMs; 1 at mamba2's training shape, 3 at zamba2's):
//   * Orientation: every L x L product is held with the key s as its row
//     and the query t >= s as its column (the upper triangle), so that
//     dx (rows s) takes G^T as its A operand from the same fragments,
//     and colsum(R) and ddt's colD are row sums within a warp.
//   * Triangle and balance: the 16-row tiles are paired, (i, L/16-1-i),
//     so that a pair owns L/16 + 1 tiles of the triangle whatever i; its
//     4 warps take every fourth 16 x 8 half of those tiles (5, 5, 4, 4 of
//     18 at L = 128), and every fourth n8 tile of the dense products (Q,
//     dx, dB's first term).  Tiles below the diagonal are never computed.
//   * C B^T, once a block (bf16 mma.sync.m16n8k16, exact inputs), stays in
//     registers for the group; per head, dG^T = x dy^T runs on the tensor
//     cores, then each element of a tile takes its gate E = exp(seg[t] -
//     seg[s]) (computed only for s <= t), gives G = C B^T E dt[s], adds
//     dG^T C B^T E to colD, R = dG^T G to the column partials of rowsum(R)
//     (shared memory, a row per warp, added in warp order), and dG^T E
//     dt[s] to the group's sum of dCB^T (kept in the scratch, read back and
//     added by the thread that wrote it, heads in order); G replaces dG^T
//     in the registers and goes to shared memory in fragment order (9 KB a
//     pair), where the other warps of the pair read it.
//   * Products with a float32 operand run as 3xTF32 mma.sync.m16n8k8: the
//     f32 operand split hi + lo (hi its top 11 bits, lo the rest, read by
//     the tensor core to 11 bits: each product within ~2^-21 of itself).
//     Where the other operand is bf16 (x, B, C: exact in TF32) two
//     products, a.hi b + a.lo b; G^T dy takes three.  A per-row scale (W)
//     is applied after the product, so that x dK keeps its bf16 operand.
//     Plain TF32 (~2^-11 a product) or bf16 (~2^-9) would not hold the
//     gradients within 1e-4 of their max.
//   * Q = B dK^T gives dx's second term, scaled by W in registers, then
//     G^T dy adds the first; x dK gives dB's first term (times W, summed
//     over the group's heads in the scratch) and dW = rowsum(B (x dK)).
//   * The fragments of every f32 product come from shared memory with
//     one 32-bit load each, rows padded (dy and dK by 4 floats) so that a
//     warp's 32 loads fall in 32 banks; where the accumulator layout of G
//     or the bf16 pairs of x set the contraction index, the k slots tq and
//     tq + 4 of an m16n8k8 step take columns 2 tq and 2 tq + 1, and the
//     other operand is read with the same permutation.
//   * Staging: B and C of the chunk, then x, dy and dK of the first head,
//     with 16-byte `cp.async` (4-byte or element copies where a row is not
//     16-byte aligned), zero-filled to L, N and P rounded up to 16; while
//     a head computes, the next head's x and dy land in a second buffer
//     (dy's is C's space, free once C B^T is done), and its dK once this
//     head's last product has read dK.  222 KB at N = 128, P = 64; 190 KB
//     at N = 64: one block an SM, 128 registers a thread.  A shape whose
//     buffers do not fit (P = 128 with N >= 64) takes the float32 body's
//     design in bf16.
//   * seg's cotangent and ddt's base a row a thread; the reverse
//     cumulative sum, ddt and the head's dA partial in one warp (shuffle
//     scans, fixed order).
//   * Scratch: per (b, c, group) the group's sum of dCB^T (the
//     L/16 (L/16 + 1) / 2 tiles of the triangle, fragment order) and of
//     dB's first term (L x N), 9216 + 128 N floats at L = 128, and the
//     pair's sums of those: at the training shapes (256 + 8) x 25600 and
//     (216 + 8) x 17408 floats, 27.0 and 15.6 MB (the first design's
//     per-head partials: 67 and 84 MB).
// `ssd_chunk_bwd_bf16_sum_kernel` sums a pair's group partials in group
// order (the loads of eight groups in flight at once).
// `ssd_chunk_bwd_bf16_reduce_kernel`, one block of 4 warps per (b * nc +
// c, 16-row tile, dC or dB): a column (dC) or row (dB) of the summed
// triangle tiles into shared memory, then dC = (sum dCB) B and dB =
// (sum dCB)^T C + (sum of dB's first term) on the tensor cores (two TF32
// products: B and C are bf16); extra blocks sum dA over (b, c) in order.
// What is left: the first loads of a block are not hidden behind another
// block (one block an SM); at G = 1 the group partials cost as many bytes
// as the compulsory traffic; the mma.sync chains issue well below the
// TF32 peak (fragment loads, splits and address arithmetic between them);
// `wgmma` would need the triangle cut into 64-row tiles.
//
// float32 (the f32 tests), the first version:
//   * ssd_chunk_bwd_kernel, one block of 256 threads per (b * nc + c, h):
//     dx and ddt, and this head's partials of dB, dC (summed over the
//     heads) and of dA (summed over batch and chunks), into a scratch
//     buffer;
//   * ssd_chunk_bwd_reduce_kernel sums the partials in a fixed order
//     (heads 0..H-1, then (b, c) pairs in order).
// Scalar f32 FMAs: every product of the chunk (C B^T, Q, the two dx
// products, dG, dC, the two dB products) runs through one block-level
// routine, `product`, in which each thread holds an 8 x 8 register tile
// (rows ty + 16 i, columns tx + 16 j of a 16 x 16 thread grid) and the
// operands are staged through shared memory 16 contraction columns at a
// time, read from wherever they lie (global memory or the block's L x L
// tile) with any row and column stride.  Shared memory: the L x (L + 1)
// f32 tile (C B^T E, then dCB), the two staging buffers and the per-row
// vectors, ~103 KB at L = 128, whatever N and P.  The exponent above the
// diagonal is positive and never reaches exp: those entries are set to 0
// without it.  Row sums go through half-warp shuffles (the 16 threads of a
// row are one half-warp), column sums through per-ty partials in shared
// memory added in order.

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

// --------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using rt::cp_async;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::stage_bf16;
using rt::ldmatrix_x4;
using rt::mma_bf16;
using rt::mma_tf32;
using rt::tf32_hi_lo;

constexpr int kTcWarps = 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kPairWarps = 4;     // warps that share a pair of row tiles
constexpr int kItems = 5;         // 16 x 8 triangle items a warp holds
constexpr int kTiles = 2;         // n8 tiles of a warp a dense pass
constexpr int kSumThreads = 256;
constexpr int kRedWarps = 4;
constexpr int kRedThreads = 32 * kRedWarps;
constexpr int kRedTiles = kMax / 8 / kRedWarps;  // n8 tiles a reduce warp
constexpr size_t kSmemMax = 232448;  // dynamic shared memory of a block

// The partials of one (b * nc + c, head group): the group's sum of dCB^T,
// the NTRI 16 x 16 tiles of the upper triangle (tile (i, j), j >= i, at
// tile_index, 256 floats each in fragment order: n8 half, lane, 4
// accumulator values), then its sum of dB's first term, LP x NP.
struct PartDims {
  int LP, NP, LT, NTRI;
  __host__ __device__ PartDims(int L, int N)
      : LP((L + 15) / 16 * 16), NP((N + 15) / 16 * 16), LT(LP / 16),
        NTRI(LT * (LT + 1) / 2) {}
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(NTRI) * 256 + static_cast<size_t>(LP) * NP;
  }
  __host__ __device__ int tile_index(int i, int j) const {
    return i * LT - i * (i - 1) / 2 + (j - i);
  }
};

// The bf16 body's shared memory: L, N and P rounded up to 16 (zero
// filled); bf16 rows padded by 8 elements (conflict-free `ldmatrix`), f32
// rows of dy and dK by 4 floats (conflict-free fragment loads).
struct TcDims : PartDims {
  int PP, LDN, LDX, LDY, LDK;
  __host__ __device__ TcDims(int L, int N, int P)
      : PartDims(L, N), PP((P + 15) / 16 * 16), LDN(NP + 8), LDX(PP + 8),
        LDY(PP + 4), LDK(NP + 4) {}
  __host__ __device__ size_t bc_bytes() const {  // B or C
    return sizeof(bf16) * static_cast<size_t>(LP) * LDN;
  }
  __host__ __device__ size_t dy_bytes() const {
    return sizeof(float) * static_cast<size_t>(LP) * LDY;
  }
  __host__ __device__ size_t c_bytes() const {   // C, then dy's 2nd buffer
    return bc_bytes() > dy_bytes() ? bc_bytes() : dy_bytes();
  }
  __host__ __device__ size_t x_bytes() const {
    return sizeof(bf16) * static_cast<size_t>(LP) * LDX;
  }
  __host__ __device__ size_t k_bytes() const {
    return sizeof(float) * static_cast<size_t>(PP) * LDK;
  }
  __host__ __device__ size_t g_bytes() const {   // G, per pair of row tiles
    return sizeof(float) * static_cast<size_t>((LT + 1) / 2) * (LT + 1) * 256;
  }
  // dt, seg, dseg, gs, ddt's base, dW W; colD and dW, a row per warp of
  // a pair; rowsum(R), a row per warp; dtotal and A of the head
  __host__ __device__ size_t v_bytes() const {
    return sizeof(float) *
           (static_cast<size_t>(6 + 2 * kPairWarps + kTcWarps) * LP + 4);
  }
  __host__ __device__ size_t smem_bytes() const {
    return bc_bytes() + c_bytes() + dy_bytes() + 2 * x_bytes() + k_bytes() +
           g_bytes() + v_bytes();
  }
};

// Whether a shape takes the tensor-core body (its buffers fit a block).
__host__ inline bool tc_fits(int L, int N, int P) {
  return TcDims(L, N, P).smem_bytes() <= kSmemMax;
}

// rt::stage_bf16 for an f32 matrix: 16-byte copies where `vec` (cols % 4
// == 0, 16-byte aligned rows), else 4-byte ones.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int rows, int cols, size_t ld_src,
                                          int prows, int pcols, int ld,
                                          bool vec) {
  const int cpr = pcols / 4;
  for (int i = threadIdx.x; i < prows * cpr; i += kTcThreads) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 4;
    float* d = dst + r * ld + c;
    if (vec) {
      const bool ok = r < rows && c < cols;
      cp_async<16>(d, ok ? src + r * ld_src + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = r < rows && c + j < cols;
        cp_async<4>(d + j, ok ? src + r * ld_src + c + j : src, ok);
      }
    }
  }
}

// A bf16 value as a tf32 operand (exact: its bits are the top 16 of f32).
__device__ __forceinline__ uint32_t tf32_of(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Item j of a warp: the 16 x 8 half hf of tile k of its pair's list (row
// tile r0's column tiles r0..LT-1, then r1's r1..LT-1), m = 2 k + hf =
// qt + 4 j; ri which of the two row tiles, ct the column tile.
struct Item {
  int k, hf, ri, ct;
  bool on;
  __device__ Item(int j, int qt, int n0, int ns, int r0, int r1) {
    const int m = qt + kPairWarps * j;
    on = m < 2 * ns;
    k = m >> 1;
    hf = m & 1;
    ri = k < n0 ? 0 : 1;
    ct = ri == 0 ? r0 + k : r1 + (k - n0);
  }
};

// One block per (b * nc + c, group of G heads); see the header.
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_chunk_bwd_bf16_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const float* __restrict__ seg,
                          const float* __restrict__ dy,
                          const float* __restrict__ dcontrib,
                          const float* __restrict__ dtotal,
                          const float* __restrict__ dseg,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ part,
                          float* __restrict__ dA_part, int H, int P, int N,
                          int L, int G, int vec_bc, int vec_x, int vec_dy,
                          int vec_dk) {
  const TcDims d(L, N, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  bf16* B_s = reinterpret_cast<bf16*>(sp);
  sp += d.bc_bytes();
  bf16* C_s = reinterpret_cast<bf16*>(sp);        // C, then dy's buffer 1
  float* dy1 = reinterpret_cast<float*>(sp);
  sp += d.c_bytes();
  float* dy0 = reinterpret_cast<float*>(sp);
  sp += d.dy_bytes();
  bf16* x0 = reinterpret_cast<bf16*>(sp);
  sp += d.x_bytes();
  bf16* x1 = reinterpret_cast<bf16*>(sp);
  sp += d.x_bytes();
  float* dK_s = reinterpret_cast<float*>(sp);
  sp += d.k_bytes();
  float* gx = reinterpret_cast<float*>(sp);        // G, fragment order
  sp += d.g_bytes();
  float* dt_s = reinterpret_cast<float*>(sp);
  float* seg_s = dt_s + d.LP;
  float* dseg_s = seg_s + d.LP;
  float* gs_s = dseg_s + d.LP;                     // seg's cotangent
  float* base_s = gs_s + d.LP;                     // colD + dW exp(..)
  float* ww_s = base_s + d.LP;                     // dW W
  float* cd_part = ww_s + d.LP;                    // colD, a row per qt
  float* dw_part = cd_part + kPairWarps * d.LP;    // dW, a row per qt
  float* rr_part = dw_part + kPairWarps * d.LP;    // rowsum(R), per warp
  float* head_s = rr_part + kTcWarps * d.LP;       // dtotal, A of the head

  const int bc = blockIdx.x;  // b * nc + c
  const int grp = blockIdx.y;
  const size_t row0 = static_cast<size_t>(bc) * L;  // b * S + c * L
  const int h0 = grp * G;
  const int hn = min(G, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tq = lane & 3;   // fragment column (pair)
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  const size_t HP = static_cast<size_t>(H) * P;
  const int LT = d.LT, LP = d.LP;
  const int LDN = d.LDN, LDX = d.LDX, LDY = d.LDY, LDK = d.LDK;

  // this warp's pair of row tiles (r0, r1), its quarter qt of their
  // triangle items and of the dense products' n8 tiles
  const int pr = warp / kPairWarps;
  const int qt = warp % kPairWarps;
  const int r0 = pr;
  const int r1 = LT - 1 - pr;
  const int n0 = r0 <= r1 ? LT - r0 : 0;
  const int n1 = r1 > r0 ? LT - r1 : 0;
  const int ns = n0 + n1;
  const bool has[2] = {n0 > 0, n1 > 0};
  const int rows[2] = {has[0] ? r0 : 0, has[1] ? r1 : 0};  // 0 where none
  float* gpair = gx + static_cast<size_t>(pr) * (LT + 1) * 256;

  float* part_g = part + (static_cast<size_t>(bc) * gridDim.y + grp) *
                             d.floats();
  float* dB1 = part_g + static_cast<size_t>(d.NTRI) * 256;

  auto stage_xdy = [&](int h, bf16* xs, float* dys) {
    stage_bf16(xs, x + row0 * HP + static_cast<size_t>(h) * P, L, P, HP, LP,
               d.PP, LDX, vec_x);
    stage_f32(dys, dy + row0 * HP + static_cast<size_t>(h) * P, L, P, HP, LP,
              d.PP, LDY, vec_dy);
  };
  auto stage_dk = [&](int h) {
    stage_f32(dK_s,
              dcontrib + (static_cast<size_t>(bc) * H + h) * P * N, P, N,
              N, d.PP, d.NP, LDK, vec_dk);
  };

  stage_bf16(B_s, Bm + row0 * N, L, N, N, LP, d.NP, LDN, vec_bc);
  stage_bf16(C_s, Cm + row0 * N, L, N, N, LP, d.NP, LDN, vec_bc);
  cp_async_commit();
  stage_xdy(h0, x0, dy0);
  stage_dk(h0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // B C^T over this warp's items (rows s, columns t >= s), once a block
  float cbt[kItems][4];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbt[j][e] = 0.f;
  for (int kk = 0; kk < d.NP / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      ldmatrix_x4(a[ri], B_s + (16 * rows[ri] + lm_row + (lm_mat & 1) * 8) *
                                   LDN +
                             kk * 16 + (lm_mat >> 1) * 8);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item o(j, qt, n0, ns, r0, r1);
      if (!o.on) continue;
      uint32_t as[4], bk[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) as[i] = o.ri ? a[1][i] : a[0][i];
      rt::ldmatrix_x2(bk, C_s + (16 * o.ct + 8 * o.hf + lm_row) * LDN +
                              kk * 16 + (lm_mat & 1) * 8);
      mma_bf16(cbt[j], as, bk[0], bk[1]);
    }
  }
  __syncthreads();  // C is read no more: its space becomes dy's buffer 1

  for (int gi = 0; gi < hn; ++gi) {
    const int h = h0 + gi;
    const bf16* xs = (gi & 1) ? x1 : x0;
    const float* dys = (gi & 1) ? dy1 : dy0;
    if (gi + 1 < hn)  // the next head's x and dy, while this head computes
      stage_xdy(h + 1, (gi & 1) ? x0 : x1, (gi & 1) ? dy0 : dy1);
    cp_async_commit();
    if (tid < LP) {
      const bool in = tid < L;
      dt_s[tid] = in ? dt[(row0 + tid) * H + h] : 0.f;
      seg_s[tid] = in ? seg[(row0 + tid) * H + h] : 0.f;
      dseg_s[tid] = in ? dseg[(row0 + tid) * H + h] : 0.f;
    } else if (tid == LP) {
      head_s[0] = dtotal[static_cast<size_t>(bc) * H + h];
      head_s[1] = A[h];
    }
    for (int i = lane; i < LP; i += 32) rr_part[warp * LP + i] = 0.f;
    cp_async_wait<1>();
    __syncthreads();  // x, dy and dK of head h and its dt, seg are here
    const float seg_last = seg_s[L - 1];

    // ---- dG^T[s,t] = x[s] . dy[t] over the items: x exact, dy hi + lo ----
    float dg[kItems][4];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[j][e] = 0.f;
    for (int kk = 0; kk < d.PP / 8; ++kk) {
      uint32_t ax[2][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const bf16* xr = xs + (16 * rows[ri] + g) * LDX + 8 * kk + tq;
        ax[ri][0] = tf32_of(xr[0]);
        ax[ri][1] = tf32_of(xr[8 * LDX]);
        ax[ri][2] = tf32_of(xr[4]);
        ax[ri][3] = tf32_of(xr[8 * LDX + 4]);
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const Item o(j, qt, n0, ns, r0, r1);
        if (!o.on) continue;
        const float* yr = dys + (16 * o.ct + 8 * o.hf + g) * LDY + 8 * kk + tq;
        uint32_t bh0, bl0, bh1, bl1, as[4];
        tf32_hi_lo(yr[0], bh0, bl0);
        tf32_hi_lo(yr[4], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 4; ++i) as[i] = o.ri ? ax[1][i] : ax[0][i];
        mma_tf32(dg[j], as, bl0, bl1);
        mma_tf32(dg[j], as, bh0, bh1);
      }
    }

    // ---- the gate per element: G, colD, R's column sums, dCB^T ----
    float cd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // (row tile, row g / g+8)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item o(j, qt, n0, ns, r0, r1);
      if (!o.on) continue;
      const int rt = o.ri ? r1 : r0;
      float rr[2] = {0.f, 0.f};     // this lane's two columns
      float cdl[2] = {0.f, 0.f};    // its two rows
      float dcb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * rt + g + 8 * (e >> 1);
        const int t = 16 * o.ct + 8 * o.hf + 2 * tq + (e & 1);
        const bool in = s <= t && t < L;
        const float E = in ? expf(seg_s[t] - seg_s[s]) : 0.f;
        const float dts = dt_s[s];
        const float bce = cbt[j][e] * E;
        const float gv = bce * dts;
        const float dgv = dg[j][e];
        cdl[e >> 1] += dgv * bce;
        rr[e & 1] += dgv * gv;
        dcb[e] = dgv * E * dts;
        dg[j][e] = gv;
      }
      if (o.ri) {
        cd[1][0] += cdl[0];
        cd[1][1] += cdl[1];
      } else {
        cd[0][0] += cdl[0];
        cd[0][1] += cdl[1];
      }
      // column sums over the item's 16 rows (the lanes of one tq)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = rr[c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rr_part[warp * LP + 16 * o.ct + 8 * o.hf + 2 * tq + c] += v;
      }
      *reinterpret_cast<float4*>(gpair + ((o.k * 2 + o.hf) * 32 + lane) * 4) =
          make_float4(dg[j][0], dg[j][1], dg[j][2], dg[j][3]);
      // the group's sum of dCB^T, in the scratch in fragment order: this
      // thread's own write for the heads before h, read back and added
      float4* sd = reinterpret_cast<float4*>(
          part_g + static_cast<size_t>(d.tile_index(rt, o.ct)) * 256 +
          (o.hf * 32 + lane) * 4);
      float4 v = make_float4(dcb[0], dcb[1], dcb[2], dcb[3]);
      if (gi > 0) {
        const float4 u = *sd;
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *sd = v;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = quad_sum(cd[ri][i]);
        if (has[ri] && tq == 0)
          cd_part[qt * LP + 16 * rows[ri] + g + 8 * i] = v;
      }

    // ---- dB's first term W[s] (x dK)[s,n] and dW = rowsum(B (x dK)):
    //      x exact, dK hi + lo; the k slots tq, tq + 4 take p = 2tq, 2tq+1;
    //      n8 tiles qt, qt + 4, ... of N ----
    float dwp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c0 = qt; c0 < d.NP / 8; c0 += kPairWarps * kTiles) {
      // n8 tiles c0 + 4 q of N
      float acc[2][kTiles][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int q = 0; q < kTiles; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ri][q][e] = 0.f;
      float2 old1[2][2][kTiles];  // dB's first term so far (heads before h)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < kTiles; ++q) {
            const int s = 16 * rows[ri] + g + 8 * i;
            const int n = 8 * (c0 + kPairWarps * q) + 2 * tq;
            old1[ri][i][q] = make_float2(0.f, 0.f);
            if (gi > 0 && has[ri] && c0 + kPairWarps * q < d.NP / 8)
              old1[ri][i][q] = *reinterpret_cast<const float2*>(
                  dB1 + static_cast<size_t>(s) * d.NP + n);
          }
      for (int kp = 0; kp < d.PP / 8; ++kp) {
        uint32_t ax[2][4];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const uint32_t* xr = reinterpret_cast<const uint32_t*>(
              xs + (16 * rows[ri] + g) * LDX + 8 * kp + 2 * tq);
          const uint32_t u0 = xr[0];
          const uint32_t u1 = xr[4 * LDX];
          ax[ri][0] = u0 << 16;
          ax[ri][1] = u1 << 16;
          ax[ri][2] = u0 & 0xffff0000u;
          ax[ri][3] = u1 & 0xffff0000u;
        }
        uint32_t bh[kTiles][2], bl[kTiles][2];
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          const int n = 8 * min(c0 + kPairWarps * q, d.NP / 8 - 1);
          const float* kr = dK_s + (8 * kp + 2 * tq) * LDK + n + g;
          tf32_hi_lo(kr[0], bh[q][0], bl[q][0]);
          tf32_hi_lo(kr[LDK], bh[q][1], bl[q][1]);
        }
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)
#pragma unroll
          for (int q = 0; q < kTiles; ++q) {
            if (c0 + kPairWarps * q >= d.NP / 8) continue;
#pragma unroll
            for (int ri = 0; ri < 2; ++ri)
              if (has[ri]) {
                if (pass == 0)
                  mma_tf32(acc[ri][q], ax[ri], bl[q][0], bl[q][1]);
                else
                  mma_tf32(acc[ri][q], ax[ri], bh[q][0], bh[q][1]);
              }
          }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (!has[ri]) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = 16 * rows[ri] + g + 8 * i;
          const float w = expf(seg_last - seg_s[s]) * dt_s[s];
#pragma unroll
          for (int q = 0; q < kTiles; ++q) {
            if (c0 + kPairWarps * q >= d.NP / 8) continue;
            const int n = 8 * (c0 + kPairWarps * q) + 2 * tq;
            const __nv_bfloat162 b2 =
                *reinterpret_cast<const __nv_bfloat162*>(B_s + s * LDN + n);
            dwp[ri][i] += __low2float(b2) * acc[ri][q][2 * i] +
                          __high2float(b2) * acc[ri][q][2 * i + 1];
            // added to this thread's own write for the heads before h
            *reinterpret_cast<float2*>(dB1 + static_cast<size_t>(s) * d.NP +
                                       n) =
                make_float2(old1[ri][i][q].x + acc[ri][q][2 * i] * w,
                            old1[ri][i][q].y + acc[ri][q][2 * i + 1] * w);
          }
        }
      }
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = quad_sum(dwp[ri][i]);
        if (has[ri] && tq == 0)
          dw_part[qt * LP + 16 * rows[ri] + g + 8 * i] = v;
      }
    __syncthreads();  // G of every item is in shared memory

    // ---- dx[s,p] = W[s] Q[s,p] + sum_{t>=s} G^T[s,t] dy[t,p]:
    //      Q = B dK^T (B exact, dK hi + lo), then G^T dy (3xTF32); n8
    //      tiles qt, qt + 4, ... of P, kTiles a pass ----
    for (int c0 = qt; c0 < d.PP / 8; c0 += kPairWarps * kTiles) {
      float acc[2][kTiles][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int q = 0; q < kTiles; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ri][q][e] = 0.f;
      for (int kn = 0; kn < d.NP / 8; ++kn) {
        uint32_t ab[2][4];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const bf16* br = B_s + (16 * rows[ri] + g) * LDN + 8 * kn + tq;
          ab[ri][0] = tf32_of(br[0]);
          ab[ri][1] = tf32_of(br[8 * LDN]);
          ab[ri][2] = tf32_of(br[4]);
          ab[ri][3] = tf32_of(br[8 * LDN + 4]);
        }
        uint32_t bh[kTiles][2], bl[kTiles][2];
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          const int p = 8 * min(c0 + kPairWarps * q, d.PP / 8 - 1);
          const float* kr = dK_s + (p + g) * LDK + 8 * kn + tq;
          tf32_hi_lo(kr[0], bh[q][0], bl[q][0]);
          tf32_hi_lo(kr[4], bh[q][1], bl[q][1]);
        }
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)
#pragma unroll
          for (int q = 0; q < kTiles; ++q) {
            if (c0 + kPairWarps * q >= d.PP / 8) continue;
#pragma unroll
            for (int ri = 0; ri < 2; ++ri)
              if (has[ri]) {
                if (pass == 0)
                  mma_tf32(acc[ri][q], ab[ri], bl[q][0], bl[q][1]);
                else
                  mma_tf32(acc[ri][q], ab[ri], bh[q][0], bh[q][1]);
              }
          }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = 16 * rows[ri] + g + 8 * i;
          const float w = expf(seg_last - seg_s[s]) * dt_s[s];
#pragma unroll
          for (int q = 0; q < kTiles; ++q) {
            acc[ri][q][2 * i] *= w;
            acc[ri][q][2 * i + 1] *= w;
          }
        }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (!has[ri]) continue;
        const int rt = rows[ri];
        for (int ct = rt; ct < LT; ++ct) {
          const int k = ri == 0 ? ct - r0 : n0 + ct - r1;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            // A = G^T: accumulator columns 2tq, 2tq+1 as k slots tq, tq+4
            const float4 gv = *reinterpret_cast<const float4*>(
                gpair + ((k * 2 + hf) * 32 + lane) * 4);
            uint32_t ah[4], al[4];
            tf32_hi_lo(gv.x, ah[0], al[0]);
            tf32_hi_lo(gv.z, ah[1], al[1]);
            tf32_hi_lo(gv.y, ah[2], al[2]);
            tf32_hi_lo(gv.w, ah[3], al[3]);
            const int t = 16 * ct + 8 * hf + 2 * tq;
            uint32_t bh[kTiles][2], bl[kTiles][2];
#pragma unroll
            for (int q = 0; q < kTiles; ++q) {
              const int p = 8 * min(c0 + kPairWarps * q, d.PP / 8 - 1);
              const float* yr = dys + t * LDY + p + g;
              tf32_hi_lo(yr[0], bh[q][0], bl[q][0]);
              tf32_hi_lo(yr[LDY], bh[q][1], bl[q][1]);
            }
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)
#pragma unroll
              for (int q = 0; q < kTiles; ++q) {
                if (c0 + kPairWarps * q >= d.PP / 8) continue;
                if (pass == 0)
                  mma_tf32(acc[ri][q], al, bh[q][0], bh[q][1]);
                else if (pass == 1)
                  mma_tf32(acc[ri][q], ah, bl[q][0], bl[q][1]);
                else
                  mma_tf32(acc[ri][q], ah, bh[q][0], bh[q][1]);
              }
          }
        }
      }
      float* dxh = dx + row0 * HP + static_cast<size_t>(h) * P;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (!has[ri]) continue;
#pragma unroll
        for (int q = 0; q < kTiles; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = 16 * rows[ri] + g + 8 * i;
            const int p = 8 * (c0 + kPairWarps * q) + 2 * tq;
            if (c0 + kPairWarps * q >= d.PP / 8 || s >= L || p >= P) continue;
            float* dst = dxh + s * HP + p;
            if (p + 1 < P && (P & 1) == 0) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc[ri][q][2 * i], acc[ri][q][2 * i + 1]);
            } else {
              dst[0] = acc[ri][q][2 * i];
              if (p + 1 < P) dst[1] = acc[ri][q][2 * i + 1];
            }
          }
      }
    }
    __syncthreads();  // dK, dy and G are read; colD, dW, rowsum(R) are in
    if (gi + 1 < hn) stage_dk(h + 1);
    cp_async_commit();

    // ---- seg's cotangent gs and ddt's base, a row a thread; then gs's
    //      reverse cumulative sum rc, ddt and dA in warp 0, 4 rows a lane ----
    if (tid < LP) {
      const int u = tid;
      float gsv = 0.f, base = 0.f, ww = 0.f;
      if (u < L) {
        float rowR = 0.f, cdv = 0.f, dwv = 0.f;
        for (int w = 0; w < kTcWarps; ++w) rowR += rr_part[w * LP + u];
        for (int w = 0; w < kPairWarps; ++w) {
          cdv += cd_part[w * LP + u];
          dwv += dw_part[w * LP + u];
        }
        const float ew = expf(seg_last - seg_s[u]);
        ww = dwv * ew * dt_s[u];
        gsv = dseg_s[u] + rowR - dt_s[u] * cdv - ww;
        base = cdv + dwv * ew;
      }
      gs_s[u] = gsv;
      base_s[u] = base;
      ww_s[u] = ww;
    }
    __syncthreads();
    if (warp == 0) {
      float gsv[4];
      float wsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = 4 * lane + j;
        gsv[j] = u < LP ? gs_s[u] : 0.f;
        wsum += u < LP ? ww_s[u] : 0.f;
      }
      wsum = rt::warp_sum(wsum);
      if ((L - 1) >> 2 == lane)
        gsv[(L - 1) & 3] += wsum + head_s[0] * expf(seg_last);
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        run += gsv[j];
        loc[j] = run;
      }
      float incl = run;  // sum of this lane's rows and every later lane's
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float later = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) later = 0.f;
      const float a_h = head_s[1];
      float da = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = 4 * lane + j;
        if (u < L) {
          const float rc = loc[j] + later;
          ddt[(row0 + u) * H + h] = base_s[u] + a_h * rc;
          da += dt_s[u] * rc;
        }
      }
      da = rt::warp_sum(da);
      if (lane == 0) dA_part[static_cast<size_t>(bc) * H + h] = da;
    }
    __syncthreads();  // dt, seg and the partial rows are rewritten next
  }
}

// The sum over the ng groups of a pair's partials, in group order, into
// `sums` (one PartDims::floats() block per pair): grid (float4s / 256,
// BC), the loads of eight groups issued before their adds.
__global__ void __launch_bounds__(kSumThreads)
ssd_chunk_bwd_bf16_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ sums, int pf, int ng) {
  const int f = blockIdx.x * kSumThreads + threadIdx.x;
  if (4 * f >= pf) return;
  const size_t bc = blockIdx.y;
  const float4* src =
      reinterpret_cast<const float4*>(part + bc * ng * pf) + f;
  const size_t step = pf / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int gg = 0;
  for (; gg + 8 <= ng; gg += 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(src + (gg + i) * step);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s.x += v[i].x;
      s.y += v[i].y;
      s.z += v[i].z;
      s.w += v[i].w;
    }
  }
  for (; gg < ng; ++gg) {
    const float4 v = __ldg(src + gg * step);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<float4*>(sums + bc * pf)[f] = s;
}

// One block of 4 warps per (b * nc + c, 16-row tile r, role): role 0 the
// rows t of dC = (sum dCB) B, from the column r of triangle tiles (i, r),
// i <= r; role 1 the rows s of dB = (sum dCB^T) C + (sum of dB's first
// term), from the row r of tiles (r, j), j >= r; both read a pair's sums.
// Blocks past BC * LT * 2 sum dA over (b, c) in order, 128 heads each.
__global__ void __launch_bounds__(kRedThreads)
ssd_chunk_bwd_bf16_reduce_kernel(const float* __restrict__ sums,
                                 const float* __restrict__ dA_part,
                                 const bf16* __restrict__ Bm,
                                 const bf16* __restrict__ Cm,
                                 float* __restrict__ dB,
                                 float* __restrict__ dC,
                                 float* __restrict__ dA, int BC, int H,
                                 int N, int L) {
  const PartDims d(L, N);
  const int LDT = d.LP + 4;
  __shared__ float T_s[16 * (kMax + 4)];  // 16 rows of the summed tiles
  __shared__ __align__(16) bf16 O_s[kMax * (kMax + 8)];  // B or C rows
  const int nred = BC * d.LT * 2;
  const int bid = blockIdx.x;
  const int tid = threadIdx.x;
  if (bid >= nred) {
    const int h = (bid - nred) * kRedThreads + tid;
    if (h < H) {
      float s = 0.f;
      for (int b = 0; b < BC; ++b) s += dA_part[static_cast<size_t>(b) * H + h];
      dA[h] = s;
    }
    return;
  }
  const int role = bid & 1;
  const int r = (bid >> 1) % d.LT;
  const int bc = (bid >> 1) / d.LT;
  const size_t row0 = static_cast<size_t>(bc) * L;
  const float* pbc = sums + static_cast<size_t>(bc) * d.floats();
  const int nt = role ? d.LT - r : r + 1;  // tiles of the row or column
  const int k0 = role ? 16 * r : 0;        // first contraction index

  // the contraction rows k0 .. k0 + 16 nt of B (dC) or C (dB), zero past
  // L and N
  const bf16* op = (role ? Cm : Bm) + row0 * N;
  const int LDO = d.NP + 8;
  const int cpr = d.NP / 8;  // 8-element chunks a row
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(op) % 16 == 0;
  for (int i = tid; i < 16 * nt * cpr; i += kRedThreads) {
    const int k = i / cpr;
    const int n = (i - k * cpr) * 8;
    bf16* dst = O_s + k * LDO + n;
    if (vec) {
      const bool ok = k0 + k < L && n < N;
      cp_async<16>(dst, ok ? op + (k0 + k) * N + n : op, ok);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        dst[c] = k0 + k < L && n + c < N ? op[(k0 + k) * N + n + c]
                                         : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  for (int i = tid; i < nt * 64; i += kRedThreads) {
    const int j = i >> 6;
    const int w = i & 63;  // float4 w of the tile: n8 half w / 32, lane w % 32
    const size_t off =
        static_cast<size_t>(role ? d.tile_index(r, r + j) : d.tile_index(j, r)) *
            256 +
        w * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(pbc + off));
    const float e4[4] = {v.x, v.y, v.z, v.w};
    const int ln = w & 31;
    const int hf = w >> 5;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sl = (ln >> 2) + 8 * (e >> 1);          // row in its tile
      const int tl = 8 * hf + 2 * (ln & 3) + (e & 1);   // column in its tile
      if (role)
        T_s[sl * LDT + 16 * j + tl] = e4[e];
      else
        T_s[tl * LDT + 16 * j + sl] = e4[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // role 1: dB's first term, summed over the groups, starts the sums
  float acc[kRedTiles][4];
#pragma unroll
  for (int j = 0; j < kRedTiles; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * r + g + 8 * i;
      const int n = 8 * (warp + kRedWarps * j) + 2 * tq;
      float2 u = make_float2(0.f, 0.f);
      if (role && n < d.NP)
        u = __ldg(reinterpret_cast<const float2*>(
            pbc + static_cast<size_t>(d.NTRI) * 256 +
            static_cast<size_t>(row) * d.NP + n));
      acc[j][2 * i] = u.x;
      acc[j][2 * i + 1] = u.y;
    }
  for (int kk = 0; kk < 2 * nt; ++kk) {
    const float* tr = T_s + g * LDT + 8 * kk + tq;
    uint32_t ah[4], al[4];
    tf32_hi_lo(tr[0], ah[0], al[0]);
    tf32_hi_lo(tr[8 * LDT], ah[1], al[1]);
    tf32_hi_lo(tr[4], ah[2], al[2]);
    tf32_hi_lo(tr[8 * LDT + 4], ah[3], al[3]);
    const bf16* orow = O_s + (8 * kk + tq) * LDO + g;
#pragma unroll
    for (int j = 0; j < kRedTiles; ++j) {
      const int n8 = 8 * (warp + kRedWarps * j);
      if (n8 >= d.NP) continue;
      const uint32_t b0 = tf32_of(orow[n8]);
      const uint32_t b1 = tf32_of(orow[4 * LDO + n8]);
      mma_tf32(acc[j], al, b0, b1);
      mma_tf32(acc[j], ah, b0, b1);
    }
  }
  float* out = role ? dB : dC;
#pragma unroll
  for (int j = 0; j < kRedTiles; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * r + g + 8 * i;
      const int n = 8 * (warp + kRedWarps * j) + 2 * tq;
      if (row >= L || n >= N) continue;
      out[(row0 + row) * N + n] = acc[j][2 * i];
      if (n + 1 < N) out[(row0 + row) * N + n + 1] = acc[j][2 * i + 1];
    }
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* seg, const void* dy,
                const void* dcontrib, const void* dtotal, const void* dseg,
                void* dx, void* ddt, void* dA, void* dB, void* dC,
                void* scratch, int Bsz, int S, int H, int P, int N, int L,
                int G, cudaStream_t stream) {
  const int BC = Bsz * (S / L);
  if (G < 1 || (H + G - 1) / G > 65535 || BC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (H + G - 1) / G;
  const TcDims d(L, N, P);
  const size_t smem = d.smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_bc = N % 8 == 0 && a16(Bm) && a16(Cm);
  const int vec_x = P % 8 == 0 && a16(x);
  const int vec_dy = P % 4 == 0 && a16(dy);
  const int vec_dk = N % 4 == 0 && a16(dcontrib);
  const size_t pf = d.floats();
  float* part = static_cast<float*>(scratch);
  float* sums = part + static_cast<size_t>(BC) * ng * pf;
  float* dA_part = sums + static_cast<size_t>(BC) * pf;
  ssd_chunk_bwd_bf16_kernel<<<dim3(BC, ng), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(seg),
      static_cast<const float*>(dy), static_cast<const float*>(dcontrib),
      static_cast<const float*>(dtotal), static_cast<const float*>(dseg),
      static_cast<float*>(dx), static_cast<float*>(ddt), part, dA_part, H, P,
      N, L, G, vec_bc, vec_x, vec_dy, vec_dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int f4 = static_cast<int>(pf / 4);
  ssd_chunk_bwd_bf16_sum_kernel<<<dim3((f4 + kSumThreads - 1) / kSumThreads,
                                       BC),
                                  kSumThreads, 0, stream>>>(
      part, sums, static_cast<int>(pf), ng);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = BC * d.LT * 2 + (H + kRedThreads - 1) / kRedThreads;
  ssd_chunk_bwd_bf16_reduce_kernel<<<blocks, kRedThreads, 0, stream>>>(
      sums, dA_part, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA), BC, H, N, L);
  return static_cast<int>(cudaGetLastError());
}

// The scratch floats of a call: the tensor-core body's group partials or
// the scalar body's head partials, and the dA partials.
size_t scratch_floats(int Bsz, int S, int H, int P, int N, int L, int G,
                      int dtype) {
  const size_t BC = static_cast<size_t>(Bsz) * (S / L);
  if (dtype == rt::kBF16 && tc_fits(L, N, P))
    return BC * ((H + G - 1) / G + 1) * PartDims(L, N).floats() + BC * H;
  return 2 * BC * H * L * N + BC * H;
}

bool valid(int Bsz, int S, int H, int P, int N, int L, int G, int dtype) {
  return L >= 1 && L <= kMax && N >= 1 && N <= kMax && P >= 1 &&
         P <= kMax && Bsz >= 1 && H >= 1 && S % L == 0 && G >= 1 &&
         (dtype == rt::kF32 || dtype == rt::kBF16);
}

}  // namespace

RT_DEFINE_ERROR_STRING

// The floats of scratch a call with these arguments needs, into *floats;
// returns 0, or cudaErrorInvalidValue for arguments the launch refuses.
extern "C" int ssd_chunk_bwd_scratch(int Bsz, int S, int H, int P, int N,
                                     int L, int group, int dtype,
                                     long long* floats) {
  if (!valid(Bsz, S, H, P, N, L, group, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  *floats = static_cast<long long>(
      scratch_floats(Bsz, S, H, P, N, L, group, dtype));
  return 0;
}

// Returns cudaGetLastError() after the launches (0 on success).  The
// caller checks shapes, dtypes and contiguity: S a multiple of L; L, N, P
// in 1..128; x, Bm, Cm of one dtype (`dtype`); every other input and every
// output f32; `scratch` holds ssd_chunk_bwd_scratch's floats.  `group` is
// the heads a block of the bf16 body takes (kernels/ssd_scan_bwd.py
// bwd_head_group); the scalar body takes one head a block and ignores it.
// bf16 inputs take the tensor-core body where its buffers fit a block
// (tc_fits), else the scalar body.  Outputs: dx (B,S,H,P), ddt (B,S,H),
// dA (H,), dB and dC (B,S,N).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* seg, const void* dy, const void* dcontrib,
    const void* dtotal, const void* dseg, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* scratch, int Bsz, int S, int H, int P, int N,
    int L, int group, int dtype, void* stream) {
  if (!valid(Bsz, S, H, P, N, L, group, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16 && tc_fits(L, N, P))
    return launch_bf16(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg, dx,
                       ddt, dA, dB, dC, scratch, Bsz, S, H, P, N, L, group,
                       st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal,
                                 dseg, dx, ddt, dA, dB, dC, scratch, Bsz, S,
                                 H, P, N, L, st);
  return launch<float>(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg, dx,
                       ddt, dA, dB, dC, scratch, Bsz, S, H, P, N, L, st);
}
