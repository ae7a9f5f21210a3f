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
// Keys at or past n are never read, as the Pallas kernel skips the blocks
// past kv_len.  With n == 0 the output is 0 and the lse -1e30 +
// log(1e-30), as in the Pallas kernel (its plain version gives the mean of
// v there).
//
// What bounds it on an H100: latency.  Each (b, kv head) reads its n
// cached keys and values once and does 2 flops per element read for each
// of its query heads (about 1 flop per byte in bf16, far below the ~295
// flop/byte at which the tensor cores would become the limit), so there is
// no tensor-core work.  At the serving shapes the whole cache is 1.9-8.8
// MB (0.6-2.7 us at 3.35 TB/s); what costs time is the chain of dependent
// steps in a block (kv_len, then the cache rows, then the scores, the
// softmax and P V, then the merges) and the instructions each SM executes
// when few blocks carry all the work.  The design:
//   * Groups: one block per (b, kv head, key split) computes all the query
//     heads of that kv head (up to 4, a template parameter; a larger group
//     is cut into blocks of a divisor of it), so the cache rows are read
//     from device memory once per group, and each row is converted to f32
//     once for all its heads.
//   * Loads: a lane loads 8 elements of a key or value row (one 16-byte
//     load in bf16, two in f32; element by element where rows are not
//     16-byte aligned).  The lanes of a key are a power of 2 (16 for rows
//     of 128, 16 with 6 idle for rows of 80), so a warp-load covers 2
//     keys.  Each lane starts all its loads of a round (8 keys in bf16, 4
//     in f32, each with its value row) before it uses any, so the
//     latencies overlap.  A dot product is summed over its key's lanes by
//     a butterfly of shuffles, the keys' shuffles side by side.
//   * Softmax: each key slot of a warp keeps its own online softmax state
//     (m, l, acc) in f32, so a round needs no reduction across the warp;
//     the slots, then the 8 warps (through shared memory), are merged with
//     the LSE combine (m = max m_w, l = sum l_w e^(m_w - m), acc likewise)
//     in a fixed order.  e^x is computed as 2^(x log2 e).
//   * Split keys: the wrapper splits [0, S) into `splits` balanced ranges
//     (kernels/flash_decode.py num_splits) so that the blocks fill the
//     SMs where the cache is long enough.  With splits > 1 each block
//     writes its (m, l, acc) to an f32 scratch buffer, and the last block
//     of a (b, kv head, head block) to finish, found with an atomicAdd
//     ticket after a __threadfence(), combines them in the same launch, in
//     one pass in split order, and resets the ticket to 0 for the next
//     call.  Splits with no valid key contribute nothing (m = -1e30, l =
//     0, acc = 0).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 4;   // query heads per block
constexpr int kMaxD = 256;
constexpr int kVec = 8;        // elements a lane loads per row

constexpr float kLog2e = 1.4426950408889634f;

// e^x as 2^(x log2 e), on the ex2 unit; e^(-1e30 - m) is still 0.
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * kLog2e); }

// 8 consecutive elements of a row, as raw 16-byte words.
template <typename T>
struct Row8 {
  static constexpr int kWords = static_cast<int>(sizeof(T)) / 2;
  uint4 w[kWords];

  // Elements c*8 .. c*8+7 of `row` (width elements): 16-byte loads where
  // the rows are 16-byte aligned, else element by element, zero past
  // width.
  __device__ __forceinline__ void load(const T* row, int c, int width,
                                       bool aligned) {
    if (aligned) {
      const uint4* p = reinterpret_cast<const uint4*>(row + c * kVec);
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = __ldg(p + i);
    } else {
      T* e = reinterpret_cast<T*>(w);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        e[i] = c * kVec + i < width ? row[c * kVec + i] : rt::from_float<T>(0.f);
    }
  }
  __device__ __forceinline__ void to_float(float (&f)[kVec]) const {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      f[i] = rt::to_float(reinterpret_cast<const T*>(w)[i]);
  }
};

// GB query heads per block share each k and v row a lane loads.
template <typename T, int GB>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int H, int Hkv, int S, int D, int Dv, int splits,
                    float sm_scale, int aligned, int lpk) {
  // Keys each lane keeps in flight per round: 8 in bf16, 4 in f32 (the
  // same 128 bytes of k and of v rows).
  constexpr int kUnroll = sizeof(T) == 2 ? 8 : 4;
  extern __shared__ float acc_s[];           // [kWarps][GB][Dv]
  __shared__ float m_s[kWarps][GB];
  __shared__ float l_s[kWarps][GB];
  __shared__ float stat_s[2][GB];            // the block's (M, L) per head
  __shared__ int last_s;

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int nsub = (H / Hkv) / GB;           // head blocks per kv head
  const int hk = blockIdx.y / nsub;
  const int h0 = hk * (H / Hkv) + (blockIdx.y - hk * nsub) * GB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // lpk lanes per key (lanes_per_key), kpw keys per warp-load; lane
  // `chunk` of a key holds its piece `chunk`.
  const int kpw = 32 / lpk;
  const int slot = lane / lpk;
  const int chunk = lane - slot * lpk;

  float qf[GB][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int d = chunk * kVec + i;
      qf[g][i] = d < D ? rt::to_float(q[(static_cast<size_t>(b) * H + h0 + g) * D + d])
                       : 0.f;
    }

  int n = kv_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int lo = static_cast<int>(static_cast<long long>(split) * S / splits);
  const int hi = static_cast<int>(static_cast<long long>(split + 1) * S / splits);
  const int end = min(hi, n);

  const T* kp = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + hk) * S * Dv;

  float m[GB], l[GB], acc[GB][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const int per_warp = kUnroll * kpw;
  for (int base = lo + warp * per_warp; base < end; base += kWarps * per_warp) {
    Row8<T> kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * kpw + slot;
      ok[u] = key < end;
      kr[u] = Row8<T>{};
      vr[u] = Row8<T>{};
      if (ok[u] && chunk * kVec < D)
        kr[u].load(kp + static_cast<size_t>(key) * D, chunk, D, aligned);
      if (ok[u] && chunk * kVec < Dv)
        vr[u].load(vp + static_cast<size_t>(key) * Dv, chunk, Dv, aligned);
    }
    // Scores: each k row is converted once for all GB heads.
    float s[GB][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      kr[u].to_float(kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        s[g][u] = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s[g][u] += qf[g][i] * kf[i];
      }
    }
    // Sum each dot product over the lpk lanes of its key (a butterfly, so
    // every lane of the key holds the sum); the GB * kUnroll shuffles of a
    // step are independent and overlap.
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      if (off >= lpk) continue;
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
    }
    // Online softmax per head and key slot: every lane of a slot holds the
    // same (m, l), so a round needs no reduction across the warp.  A slot
    // with no valid key in the round keeps m, and gets p = 0.
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = rt::kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[g][u] = ok[u] ? s[g][u] * sm_scale : rt::kNegInf;
        mx = fmaxf(mx, s[g][u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp_e(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[g][u] = ok[u] ? exp_e(s[g][u] - m_new) : 0.f;   // now p
        psum += s[g][u];
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] *= corr;
    }
    // acc += p v: each v row is converted once for all GB heads.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[kVec];
      vr[u].to_float(vf);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] += s[g][u] * vf[i];
    }
  }

  // Combine the warp's key slots (LSE): slot 0 ends with the warp's acc,
  // lane 0 with its (m, l).
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float mw = rt::warp_max(m[g]);
    const float f = exp_e(m[g] - mw);
    l[g] = rt::warp_sum(chunk == 0 ? l[g] * f : 0.f);   // once per slot
    m[g] = mw;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] *= f;
  }
  for (int s2 = 1; s2 < kpw; ++s2)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float o = __shfl_sync(0xffffffffu, acc[g][i], (lane + s2 * lpk) & 31);
        if (slot == 0) acc[g][i] += o;
      }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int dv = chunk * kVec + i;
        if (dv < Dv) acc_s[(warp * GB + g) * Dv + dv] = acc[g][i];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();

  // Combine the warps (LSE, in a fixed order): one thread per head forms
  // each warp's factor e^(m_w - M) and the block's (M, L).
  if (tid < GB) {
    const int g = tid;
    float M = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w][g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp_e(m_s[w][g] - M);
      L += l_s[w][g] * f;
      l_s[w][g] = f;                           // now the factor
    }
    stat_s[0][g] = M;
    stat_s[1][g] = L;
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(Dv) + 2;   // [m, l, acc[Dv]]
  for (int idx = tid; idx < GB * Dv; idx += kThreads) {
    const int g = idx / Dv;
    const int dv = idx - g * Dv;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A += acc_s[(w * GB + g) * Dv + dv] * l_s[w][g];
    const size_t bh = static_cast<size_t>(b) * H + h0 + g;
    const float M = stat_s[0][g], L = stat_s[1][g];
    if (splits == 1) {
      const float lc = fmaxf(L, 1e-30f);
      out[bh * Dv + dv] = rt::from_float<T>(A / lc);
      if (lse != nullptr && dv == 0) lse[bh] = M + logf(lc);
    } else {
      float* pp = part + (bh * splits + split) * stride;
      pp[2 + dv] = A;
      if (dv == 0) {
        pp[0] = M;
        pp[1] = L;
      }
    }
  }
  if (splits == 1) return;

  // The last block of this (b, kv head, head block) to finish combines
  // the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + static_cast<size_t>(b) * gridDim.y + blockIdx.y;
    const int done = atomicAdd(ticket, 1);
    last_s = done == splits - 1;
    if (last_s) *ticket = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // One pass over the splits per (head, column), in split order: the
  // loads of a split do not wait for the previous split's sums.
  for (int idx = tid; idx < GB * Dv; idx += kThreads) {
    const int g = idx / Dv;
    const int dv = idx - g * Dv;
    const size_t bh = static_cast<size_t>(b) * H + h0 + g;
    const float* pp = part + bh * splits * stride;
    float M = rt::kNegInf, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s2 = 0; s2 < splits; ++s2) {
      const float* ps = pp + s2 * stride;
      const float ms = __ldcg(ps), ls = __ldcg(ps + 1), as = __ldcg(ps + 2 + dv);
      const float m_new = fmaxf(M, ms);
      const float c = exp_e(M - m_new), f = exp_e(ms - m_new);
      L = L * c + ls * f;
      A = A * c + as * f;
      M = m_new;
    }
    const float lc = fmaxf(L, 1e-30f);
    out[bh * Dv + dv] = rt::from_float<T>(A / lc);
    if (lse != nullptr && dv == 0) lse[bh] = M + logf(lc);
  }
}

// Lanes per key: a power of 2 with enough 8-element pieces for the wider
// of a k and a v row (the lanes past the row idle).
int lanes_per_key(int D, int Dv) {
  const int pieces = (max(D, Dv) + kVec - 1) / kVec;
  int lpk = 1;
  while (lpk < pieces) lpk <<= 1;
  return lpk;
}

template <typename T, int GB>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, void* part, void* tickets, int B, int H,
           int Hkv, int S, int D, int Dv, int splits, float sm_scale,
           cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int aligned = D % kVec == 0 && Dv % kVec == 0 && addr % 16 == 0;
  const dim3 grid(splits, H / GB, B);
  const int lpk = lanes_per_key(D, Dv);
  const size_t smem = sizeof(float) * kWarps * GB * Dv;
  flash_decode_kernel<T, GB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(part), static_cast<int*>(tickets), H, Hkv, S, D,
      Dv, splits, sm_scale, aligned, lpk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, void* lse, void* part, void* tickets, int B, int H,
             int Hkv, int S, int D, int Dv, int splits, float sm_scale,
             cudaStream_t stream) {
  // Query heads per block: the largest divisor of the group up to
  // kMaxGroup.
  const int group = H / Hkv;
  int gb = kMaxGroup;
  while (group % gb != 0) --gb;
  switch (gb) {
#define RT_FD_CASE(GB)                                                   \
  case GB:                                                               \
    return launch<T, GB>(q, k, v, kv_len, out, lse, part, tickets, B, H, \
                         Hkv, S, D, Dv, splits, sm_scale, stream);
    RT_FD_CASE(1) RT_FD_CASE(2) RT_FD_CASE(3) RT_FD_CASE(4)
#undef RT_FD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

RT_DEFINE_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes and contiguity; D and Dv must be at most 256.
// With splits > 1, `part` holds at least B * H * splits * (Dv + 2) floats
// and `tickets` at least B * H ints, all 0 on entry (and again on exit).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* out, void* lse, void* part,
                                   void* tickets, int B, int H, int Hkv,
                                   int S, int D, int Dv, int splits,
                                   float sm_scale, int dtype, void* stream) {
  if (D > kMaxD || Dv > kMaxD || D < 1 || Dv < 1 || Hkv <= 0 ||
      H % Hkv != 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_t<float>(q, k, v, kv_len, out, lse, part, tickets, B, H,
                             Hkv, S, D, Dv, splits, sm_scale, st);
    case rt::kBF16:
      return launch_t<__nv_bfloat16>(q, k, v, kv_len, out, lse, part,
                                     tickets, B, H, Hkv, S, D, Dv, splits,
                                     sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
