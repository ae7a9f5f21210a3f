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
// With a query offset (an int32 vector q_offset (B,) on the device), row i
// of lane b stands at key position p = q_offset[b] + i: key j is valid iff
// j < Sk and j < q_offset[b] + S, and j <= p when causal, and p - j <
// window when a window is given (the IR attention of the LM decode path,
// src/repro/core/ir.py `_attention_ref`, whose Pallas counterpart has no
// such argument).  Each block reads its lane's offset, so one launch serves
// lanes at different positions; a null q_offset is the mask above.
// With an lse pointer (float32 (B,H,S) on the device) each row's
// log-sum-exp m + log(max(l, 1e-30)) of its scaled, masked scores is also
// written: the residual the backward (flash_attention_bwd.cu) recomputes P
// from, as `_flash_fwd_lse` of src/repro/kernels/ref.py returns it.  Serving
// passes none.
// The softmax runs streamed over key tiles with f32 running max, sum and
// accumulator; the output is rounded to the input dtype.  Key tiles that
// the causal or window mask hides from every row of a query tile are
// skipped, as the Pallas kernel skips its blocks; a masked key inside a
// tile that runs gets exp(-1e30 - m) = 0, exactly as there.
//
// Each dtype has one body, chosen by the launch function:
//
// bfloat16 (every serving path): `flash_attention_bf16_kernel`, on the
// tensor cores.
//   What bounds it on an H100: at the prefill shapes of the serving paths
//   (S = 100-200, head dim 80-128, batch 4, 32 heads) device memory and
//   latency, not operations: q, k, v and o are 13-16 MB (3.9-4.9 us at
//   3.35 TB/s) against 0.3 us of bf16 tensor-core work.  So the design
//   reads each k/v tile once per 128 query rows with 16-byte asynchronous
//   copies that overlap the previous tile's products, and keeps S and P
//   in registers.
//   Design: one block of 8 warps per (128-row query tile, h, b), grid
//   (ceil(S/128), H, B), the heavier late causal tiles launched first.
//   (Against 64-row tiles of 4 warps, this halves the k and v reads at
//   S <= 128, and at S = 200 reads 6 key tiles per head instead of 10.)
//   Each warp owns 16 query rows and skips the key tiles its rows cannot
//   see.  Q and double-buffered K/V tiles of 64 keys (32 when the head
//   dim is above 128) are copied into shared memory with `cp.async` (16
//   bytes a thread), rows padded by 16 bytes so that `ldmatrix` reads
//   them without bank conflicts; a head dim that is not a multiple of 16
//   is zero-filled up to one in shared memory (48 runs the 64 body).
//   Q's fragments are loaded once into registers (head dim <= 128; above,
//   from shared memory for each tile).  S = Q K^T and O += P V run on
//   `mma.sync.m16n8k16` bf16 with f32 accumulators; V's B fragments come
//   from `ldmatrix.trans`.  The online softmax stays in registers: each
//   row's max and sum are reduced over the 4 lanes that hold it.
//   Rounding of P: P is rounded to bf16 for the P V product, as PyTorch's
//   flash SDPA does (the Pallas kernel keeps it in f32,
//   src/repro/kernels/flash_attention.py:68-73), and the row sum l is
//   taken from the same rounded P, so the output stays a convex
//   combination of rows of v; the rounding moves each weight by at most
//   2^-8 of itself.
//   Epilogue: out = acc / max(l, 1e-30), rounded with __float2bfloat16,
//   staged through the warp's rows of shared memory and written with
//   16-byte stores.  wgmma + TMA would pay off where the products bound
//   the kernel, at prompts in the thousands.
//
// float32 (the f32 agreement checks at full width and the f32 tests):
// `flash_attention_kernel`, scalar f32 FMAs from shared memory.  One
// block of 256 threads per (query tile of 16 rows, h, b), grid
// (ceil(S/16), H, B).  The block holds its q tile in shared memory as f32
// and walks the key tiles of 64 keys that some row of it can see.  For
// each key tile it stages K (rows padded to D+1 floats, so the score loop
// reads 32 distinct banks) and V in shared memory, computes the 16x64
// scores (each thread one key column, four rows), updates the row
// statistics with one warp per row, and accumulates P @ V with each thread
// owning 4 rows x up to 4 output columns in registers.
//
// No score matrix ever reaches device memory.

#include <cstdint>

#include "common.cuh"

namespace {

// --------------------------------------------------------------------------
// float32: scalar FMAs
// --------------------------------------------------------------------------

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse,
                       const int* __restrict__ q_offset, int H, int Hkv,
                       int S, int Sk, int D, int Dv, float sm_scale,
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
  // this lane's query offset and the end of the keys its rows may see
  const int off = q_offset ? q_offset[b] : 0;
  const int kv_lim = q_offset ? min(Sk, off + S) : Sk;
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
  int k_end = kv_lim;
  if (causal) k_end = min(kv_lim, off + q0 + kBQ);
  int k_begin = 0;
  if (window > 0) {
    const int lo = off + q0 - window + 1;  // first key row q0 can see
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
        const int qi = off + q0 + r;  // the row's key position
        bool ok = kj < kv_lim;
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
  // the row's log-sum-exp, m + log(l), for the backward
  if (lse != nullptr && tid < kBQ && q0 + tid < S)
    lse[(static_cast<size_t>(b) * H + h) * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const int* q_offset, int B, int H, int Hkv, int S,
               int Sk, int D, int Dv, float sm_scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, q_offset, H,
      Hkv, S, Sk, D, Dv, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block: 16 per warp

// Tiles for a head dim padded to DP (a multiple of 16): DP serves both D
// and Dv, each zero-filled up to DP in shared memory.
template <int DP>
struct MmaTile {
  static_assert(DP % 16 == 0 && DP <= kMaxD, "DP is a multiple of 16");
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per tile
  static constexpr int LD = DP + 8;   // row pitch in bf16: 16 bytes of pad
  static constexpr int CH = DP / 8;   // 16-byte chunks per row
  static constexpr bool kQInRegs = DP <= 128;
  static constexpr size_t kSmem =
      sizeof(bf16) * static_cast<size_t>(kMmaBQ + 4 * BK) * LD;
};

using rt::cp_async;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma_bf16;

// rows [row0, row0 + rows) of a (n_valid x width) matrix into shared memory
// at pitch LD, zero past n_valid rows and past width columns.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int n_valid,
                                          int width) {
  using Tile = MmaTile<DP>;
  for (int i = threadIdx.x; i < rows * Tile::CH; i += kMmaThreads) {
    const int r = i / Tile::CH;
    const int c = i - r * Tile::CH;
    const bool ok = row0 + r < n_valid && c * 8 < width;
    const bf16* g =
        ok ? src + static_cast<size_t>(row0 + r) * width + c * 8 : src;
    cp_async<16>(dst + r * Tile::LD + c * 8, g, ok);
  }
}

// Up to head dim 80 a block fits in 128 registers a thread, so that two
// blocks share an SM; the query offset's registers pushed the 80 body past
// 128, to one block an SM (zamba2's prefill, chip_smoke.py phase 2 on an
// H100: 17.3 -> 23.6 us), so the bound is asked for (the 64 body spills 8
// bytes under it).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 80 ? 2 : 1)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse,
                            const int* __restrict__ q_offset, int H, int Hkv,
                            int S, int Sk, int D, int Dv, float sm_scale,
                            int causal, int window) {
  using Tile = MmaTile<DP>;
  constexpr int BK = Tile::BK;
  constexpr int LD = Tile::LD;
  constexpr int KS = DP / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;    // n-tiles of S (8 keys each)
  constexpr int NO = DP / 8;    // n-tiles of O (8 columns each)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kMmaBQ x LD
  bf16* kv_s = q_s + kMmaBQ * LD;                 // [stage][K, V][BK x LD]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kMmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  // this lane's query offset and the end of the keys its rows may see
  const int off = q_offset ? q_offset[b] : 0;
  const int kv_lim = q_offset ? min(Sk, off + S) : Sk;

  const bf16* qp = q + (static_cast<size_t>(b) * H + h) * S * D;
  const bf16* kp = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const bf16* vp = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * Dv;
  bf16* op = out + (static_cast<size_t>(b) * H + h) * S * Dv;

  // Key tiles that some row of this query tile can see.
  const int k_end = causal ? min(kv_lim, off + q0 + kMmaBQ) : kv_lim;
  int k_begin = 0;
  if (window > 0) {
    const int lo = off + q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / BK) * BK;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int tile, int stage) {
    bf16* ks = kv_s + stage * 2 * BK * LD;
    const int k0 = k_begin + tile * BK;
    load_rows<DP>(ks, kp, k0, BK, Sk, D);
    load_rows<DP>(ks + BK * LD, vp, k0, BK, Sk, Dv);
  };
  load_rows<DP>(q_s, qp, q0, kMmaBQ, S, D);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // This warp's rows: w_first .. w_first + 15; this lane holds rows
  // w_first + g and w_first + g + 8.
  const int w_first = q0 + 16 * warp;
  const int row0 = w_first + g;
  const bf16* qw_s = q_s + 16 * warp * LD;
  // ldmatrix row addresses: lane l feeds row (l & 7) of matrix l >> 3.
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {rt::kNegInf, rt::kNegInf};
  float l_r[2] = {0.f, 0.f};
  uint32_t qf[Tile::kQInRegs ? KS : 1][4];
  const float scale_log2 = sm_scale * 1.4426950408889634f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = k_begin + it * BK;
    const bf16* ks = kv_s + (it & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    if constexpr (Tile::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], qw_s + (lm_row + (lm_mat & 1) * 8) * LD +
                                  kk * 16 + (lm_mat >> 1) * 8);
      }
    }
    // A warp whose rows see no key of this tile skips its products.
    const bool skip = w_first >= S || (causal && k0 > off + w_first + 15) ||
                      (window > 0 && off + w_first - (k0 + BK - 1) >= window);
    if (!skip) {
      // S = Q K^T for this warp's 16 rows and the tile's BK keys.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        if constexpr (Tile::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, qw_s + (lm_row + (lm_mat & 1) * 8) * LD + kk * 16 +
                             (lm_mat >> 1) * 8);
        }
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (j * 8 + lm_row + (lm_mat >> 1) * 8) * LD +
                              kk * 16 + (lm_mat & 1) * 8);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }

      // Scale (in log2 units) and mask, then the online softmax.
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = off + row0 + (e >> 1) * 8;  // key position
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          bool ok = kj < kv_lim;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && qi - kj < window;
          s[j][e] = ok ? s[j][e] * scale_log2 : rt::kNegInf;
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = rt::kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);
        corr[r] = exp2f(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      // P in bf16, as the A fragments of P V (k-step j/2 takes n-tiles j
      // and j + 1 of S); the row sums from the same rounded values.
      uint32_t pa[NS / 2][4];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(
              exp2f(s[j][2 * r] - m_r[r]), exp2f(s[j][2 * r + 1] - m_r[r]));
          pa[j >> 1][(j & 1) * 2 + r] = *reinterpret_cast<const uint32_t*>(&p2);
          ls[r] += __low2float(p2) + __high2float(p2);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
        l_r[r] = l_r[r] * corr[r] + ls[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (kk * 16 + lm_row + (lm_mat & 1) * 8) * LD +
                                    n * 8 + (lm_mat >> 1) * 8);
          mma_bf16(o[n], pa[kk], bv[0], bv[1]);
          mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);
        }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  // Epilogue: the warp stages its 16 output rows in its own rows of q_s
  // (no other warp reads them), then writes them with 16-byte stores.
  // With no key tile, q_s's copies may still be in flight.
  cp_async_wait<0>();
  __syncthreads();
  if (w_first >= S) return;
  bf16* ow_s = q_s + 16 * warp * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      __nv_bfloat162 o2;
      o2.x = __float2bfloat16(o[n][2 * r] / lc);
      o2.y = __float2bfloat16(o[n][2 * r + 1] / lc);
      *reinterpret_cast<__nv_bfloat162*>(ow_s + (g + 8 * r) * LD + n * 8 +
                                         2 * t) = o2;
    }
  }
  // the rows' log-sum-exp in natural units, m (log2 units) ln 2 + log(l),
  // for the backward; every lane of a row's quad holds its m and l
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        lse[(static_cast<size_t>(b) * H + h) * S + row0 + 8 * r] =
            m_r[r] * 0.6931471805599453f + logf(fmaxf(l_r[r], 1e-30f));
  }
  __syncwarp();
  const int chunks = Dv / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    if (w_first + r < S)
      *reinterpret_cast<uint4*>(op + static_cast<size_t>(w_first + r) * Dv +
                                c * 8) =
          *reinterpret_cast<const uint4*>(ow_s + r * LD + c * 8);
  }
}

template <int DP>
int launch_bf16_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, const int* q_offset, int B, int H, int Hkv,
                   int S, int Sk, int D, int Dv, float sm_scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = MmaTile<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, H, B);
  flash_attention_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, out, lse, q_offset, H, Hkv, S, Sk, D, Dv, sm_scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* q_offset, int B, int H, int Hkv, int S,
                int Sk, int D, int Dv, float sm_scale, int causal, int window,
                cudaStream_t stream) {
  // 16-byte copies need 16-byte rows and base addresses.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if (D % 8 != 0 || Dv % 8 != 0 || addr % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  // The head dim rounded up to 16; 48 runs the 64 body (ptxas spills
  // registers in a 48 instance).
  int dp = (max(D, Dv) + 15) / 16 * 16;
  if (dp == 48) dp = 64;
  switch (dp) {
#define RT_FA_CASE(DP)                                                    \
  case DP:                                                                \
    return launch_bf16_dp<DP>(qb, kb, vb, ob, lse, q_offset, B, H, Hkv,  \
                              S, Sk, D, Dv, sm_scale, causal, window,     \
                              stream);
    RT_FA_CASE(16) RT_FA_CASE(32) RT_FA_CASE(64)
    RT_FA_CASE(80) RT_FA_CASE(96) RT_FA_CASE(112) RT_FA_CASE(128)
    RT_FA_CASE(144) RT_FA_CASE(160) RT_FA_CASE(176) RT_FA_CASE(192)
    RT_FA_CASE(208) RT_FA_CASE(224) RT_FA_CASE(240) RT_FA_CASE(256)
#undef RT_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity; D and Dv must be at most 256 (and,
// in bfloat16, multiples of 8 with 16-byte aligned tensors), and
// window <= 0 means no window.  q_offset is null or an int32 (B,) device
// vector with values in [0, Sk - S].  lse is null or a float32 (B,H,S)
// device array that receives each row's log-sum-exp (natural units).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* q_offset, int B, int H,
                                      int Hkv, int S, int Sk, int D, int Dv,
                                      float sm_scale, int causal, int window,
                                      int dtype, void* stream) {
  if (D > kMaxD || Dv > kMaxD || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  float* lse_p = static_cast<float*>(lse);
  switch (dtype) {
    case rt::kF32:
      return launch_f32(q, k, v, out, lse_p, off, B, H, Hkv, S, Sk, D, Dv,
                        sm_scale, causal, window, st);
    case rt::kBF16:
      return launch_bf16(q, k, v, out, lse_p, off, B, H, Hkv, S, Sk, D, Dv,
                         sm_scale, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
