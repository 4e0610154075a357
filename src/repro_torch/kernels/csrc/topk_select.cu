// Fused EAFL reward + exact top-k client selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py
// (_topk_kernel, topk_reward): per client a fused score
//     eafl      f*a + (1-f)*b      (one fused multiply-add, see below)
//     oort      a
//     eafl-epj  a / max(b, 1e-3)
// times (1 + ucb), SENTINEL (-3e38) outside `valid`, then the k best
// clients. The result equals a global stable top-k in lax.top_k's total
// order: values descending with +0 above -0, +NaN first and -NaN last,
// ties lowest index first.
//
// Order: each score becomes the 32-bit key
//     key = bits ^ (sign ? 0xFFFFFFFF : 0x80000000),
// whose unsigned order is that total order (the port's plain version sorts
// by the same key, repro_torch/numerics.py::orderable_key). The key maps
// back to the score's bits, so only keys are kept.
//
// Bound: the function reads 13 bytes per client (three f32 arrays and a
// one-byte mask; 9 without ucb) and writes 8*k bytes. At 1,048,576 clients
// that is 13.6 MB, about 4.1 us at the H100 SXM's 3.35 TB/s; at 10,000
// clients it is launch-bound.
//
// Design: tiles of clients, then a merge of their candidate lists, with a
// radix select in shared memory instead of k rounds of argmax.
//   tiles:  one CTA of 1024 threads per tile of kTile clients (the last
//           tile takes the remainder, up to 2*kTile - 1, so every tile
//           holds at least k clients). It loads its clients once, 16
//           bytes a thread where the pointers allow, scores them exactly
//           as the reference and keeps their keys in shared memory (the
//           index is the position). While loading it counts the keys'
//           top bytes.
//   select: four 8-bit radix passes over the keys (kHists histogram
//           copies shared by groups of warps, one scan of the 256 bins)
//           narrow a prefix down to the k-th largest key T, stopping early
//           once a bin holds exactly the keys still wanted.
//   compact: every key above T, and the first (k - c) keys equal to T in
//           position order (c = the count above T), found by one block
//           prefix scan over contiguous chunks of positions, so no atomic
//           decides which of several equal keys is taken.
//   sort:   a bitonic sort of the k winners in shared memory by (key
//           descending, position ascending), padded to a power of two.
//   merge:  the same routine over the tiles' lists (key, index), laid out
//           tile by tile. Each list is sorted and covers lower indices
//           than the next, so among equal keys position order is index
//           order, and level after level keeps it. A tile count of one
//           (N < 2*kTile, e.g. N = 10,000) is a single launch; 4M clients
//           at k = 100 take two merge levels.
//
// Float semantics: build with -fmad=false. The eafl mix is evaluated as
// float(double(f)*double(a) + double(float(g*b))): the f32 product f*a is
// exact in double, so this is the fused multiply-add that the reference's
// compiler emits for f*a + g*b, and it is the expression the plain PyTorch
// version evaluates, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;       // clients a tile (the last up to 2x)
constexpr int kMaxSort = 8192;    // k padded to a power of two
constexpr int kMergeCap = 16384;  // candidates held by one merge CTA
constexpr int kHists = 8;         // histogram copies, 4 warps a copy
constexpr float kSentinel = -3e38f;
// A winner sorts as (key << 32 | position ^ kTieFlip), descending: the
// flipped position puts the lowest index first among equal keys.
constexpr uint32_t kTieFlip = 0xffffffffu;

__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint32_t bits_of(uint32_t key) {
  return (key & 0x80000000u) ? key ^ 0x80000000u : ~key;
}

__device__ __forceinline__ float score(int mode, float a, float b, float f,
                                       float g) {
  if (mode == 0) {
    double s = __dadd_rn(__dmul_rn((double)f, (double)a),
                         (double)__fmul_rn(g, b));
    return __double2float_rn(s);
  }
  if (mode == 1) return a;
  float d = (b != b || b > 1e-3f) ? b : 1e-3f;
  return __fdiv_rn(a, d);
}

__device__ __forceinline__ uint32_t client_key(int mode, float a, float b,
                                               float u, bool has_ucb,
                                               uint8_t ok, float f, float g) {
  if (ok == 0) return key_of(kSentinel);
  float v = score(mode, a, b, f, g);
  if (has_ucb) v = __fmul_rn(v, __fadd_rn(1.0f, u));
  return key_of(v);
}

// Byte offsets of the dynamic shared memory: the sort buffer (8 bytes an
// entry), the keys, the merge's indices, the histograms.
__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}
__host__ __device__ __forceinline__ int smem_bytes(int kpad, int cap,
                                                   bool merge) {
  return round16(8 * kpad) + round16(4 * cap) * (merge ? 2 : 1) +
         kHists * 256 * 4;
}

__device__ __forceinline__ void count_key(uint32_t* hist, int warp,
                                          uint32_t key, int shift) {
  atomicAdd(&hist[(warp % kHists) * 256 + ((key >> shift) & 255u)], 1u);
}

// One CTA reduces `len` entries to its k best, sorted.
// FIRST: entries are clients start .. start+len-1 scored from (a, b, ucb,
// valid); otherwise candidates (in_key, in_idx) of the previous level.
// `cap` is the most entries a CTA of this launch holds; `final_out`: write
// values (the keys' float bits) and indices + index_offset to out_bits /
// out_idx at 0; otherwise keys and indices at blockIdx.x * k.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads, 1)
topk_select(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ ucb, const uint8_t* __restrict__ valid,
            int vec, const uint32_t* __restrict__ in_key,
            const int* __restrict__ in_idx, long long n, int group_len,
            int cap, int mode, float f, float g, int k, int kpad,
            int final_out, int index_offset, uint32_t* __restrict__ out_bits,
            int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* sbuf = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + round16(8 * kpad));
  int* sidx = reinterpret_cast<int*>(smem + round16(8 * kpad) +
                                     round16(4 * cap));
  uint32_t* hist = reinterpret_cast<uint32_t*>(
      smem + smem_bytes(kpad, cap, !FIRST) - kHists * 256 * 4);
  __shared__ uint32_t s_wsum[kWarps];
  __shared__ uint32_t s_prefix, s_mask;
  __shared__ int s_need, s_done;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long start = (long long)blockIdx.x * group_len;
  long long stop = FIRST && blockIdx.x + 1 == gridDim.x
                       ? n : start + group_len;
  if (stop > n) stop = n;
  const int len = (int)(stop - start);

  for (int i = t; i < kHists * 256; i += kThreads) hist[i] = 0u;
  __syncthreads();

  // ---- load once, keep keys, count their top bytes (radix pass 0)
  if (FIRST) {
    const bool has_ucb = ucb != nullptr;
    int done = 0;
    if (vec) {
      const int n4 = len >> 2;
      for (int i = t; i < n4; i += kThreads) {
        const long long q = start + 4LL * i;
        const float4 av = *reinterpret_cast<const float4*>(a + q);
        const float4 bv = *reinterpret_cast<const float4*>(b + q);
        float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has_ucb) uv = *reinterpret_cast<const float4*>(ucb + q);
        const uchar4 m = *reinterpret_cast<const uchar4*>(valid + q);
        uint4 kv;
        kv.x = client_key(mode, av.x, bv.x, uv.x, has_ucb, m.x, f, g);
        kv.y = client_key(mode, av.y, bv.y, uv.y, has_ucb, m.y, f, g);
        kv.z = client_key(mode, av.z, bv.z, uv.z, has_ucb, m.z, f, g);
        kv.w = client_key(mode, av.w, bv.w, uv.w, has_ucb, m.w, f, g);
        *reinterpret_cast<uint4*>(skey + 4 * i) = kv;
        count_key(hist, warp, kv.x, 24);
        count_key(hist, warp, kv.y, 24);
        count_key(hist, warp, kv.z, 24);
        count_key(hist, warp, kv.w, 24);
      }
      done = 4 * n4;
    }
    for (int p = done + t; p < len; p += kThreads) {
      const long long q = start + p;
      const uint32_t key = client_key(mode, a[q], b[q],
                                      has_ucb ? ucb[q] : 0.f, has_ucb,
                                      valid[q], f, g);
      skey[p] = key;
      count_key(hist, warp, key, 24);
    }
  } else {
    for (int p = t; p < len; p += kThreads) {
      const uint32_t key = in_key[start + p];
      skey[p] = key;
      sidx[p] = in_idx[start + p];
      count_key(hist, warp, key, 24);
    }
  }

  __syncthreads();

  // ---- radix select: the prefix (under mask) of the k-th largest key,
  // and `need`, how many keys with that prefix are still wanted
  uint32_t prefix = 0u, mask = 0u;
  int need = k;
  if (len > k) {
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      if (pass > 0) {
        for (int i = t; i < kHists * 256; i += kThreads) hist[i] = 0u;
        __syncthreads();
        for (int p = t; p < len; p += kThreads) {
          const uint32_t key = skey[p];
          if ((key & mask) == prefix) count_key(hist, warp, key, shift);
        }
        __syncthreads();
      }
      if (t < 256) {  // bins from the top down, one a thread
        const uint32_t bin = 255u - t;
        uint32_t c = 0u;
#pragma unroll
        for (int h = 0; h < kHists; ++h) c += hist[h * 256 + bin];
        uint32_t s = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
          if (lane >= o) s += y;
        }
        if (lane == 31) s_wsum[warp] = s;
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        for (int w = 0; w < warp; ++w) s += s_wsum[w];
        const uint32_t above = s - c;  // keys in higher bins
        if (above < (uint32_t)need && (uint32_t)need <= s) {
          s_prefix = prefix | (bin << shift);
          s_mask = mask | (255u << shift);
          s_need = need - (int)above;
          s_done = c == (uint32_t)(need - (int)above);
        }
      }
      __syncthreads();
      prefix = s_prefix;
      mask = s_mask;
      need = s_need;
      if (s_done) break;  // the bin's keys are all wanted
    }
  }

  // ---- compact: keys above the prefix, and the first `need` equal to it
  const int per = (len + kThreads - 1) / kThreads;
  const int p0 = min(t * per, len), p1 = min(p0 + per, len);
  uint32_t n_above = 0u, n_eq = 0u;
  for (int p = p0; p < p1; ++p) {
    const uint32_t km = skey[p] & mask;
    n_above += km > prefix;
    n_eq += km == prefix;
  }
  const uint32_t mine = (n_above << 16) | n_eq;  // both < 2^16
  uint32_t s = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) s_wsum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = s_wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_wsum[lane] = w;
  }
  __syncthreads();
  const uint32_t before = s - mine + (warp > 0 ? s_wsum[warp - 1] : 0u);
  int a_rank = (int)(before >> 16), e_rank = (int)(before & 0xffffu);
  const int n_top = k - need;  // keys above the prefix
  for (int p = p0; p < p1; ++p) {
    const uint32_t key = skey[p], km = key & mask;
    int slot = -1;
    if (km > prefix) {
      slot = a_rank++;
    } else if (km == prefix) {
      if (e_rank < need) slot = n_top + e_rank;
      ++e_rank;
    }
    if (slot >= 0)
      sbuf[slot] = ((unsigned long long)key << 32) | ((uint32_t)p ^ kTieFlip);
  }
  for (int i = k + t; i < kpad; i += kThreads) sbuf[i] = 0ull;  // last
  __syncthreads();

  // ---- bitonic sort, descending
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < kpad / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long x = sbuf[lo], y = sbuf[hi];
        if ((x < y) == ((lo & size) == 0)) {
          sbuf[lo] = y;
          sbuf[hi] = x;
        }
      }
      __syncthreads();
    }
  }

  // ---- write
  for (int i = t; i < k; i += kThreads) {
    const unsigned long long e = sbuf[i];
    const uint32_t key = (uint32_t)(e >> 32);
    const int pos = (int)((uint32_t)e ^ kTieFlip);
    const int id = FIRST ? (int)(start + pos) : sidx[pos];
    if (final_out) {
      out_bits[i] = bits_of(key);
      out_idx[i] = id + index_offset;
    } else {
      const long long o = (long long)blockIdx.x * k + i;
      out_bits[o] = key;
      out_idx[o] = id;
    }
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Raises both kernels' dynamic shared-memory limit to the most a launch
// can ask for. Call once per device before the first launch; returns the
// CUDA error code.
int topk_reward_init(void) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_select<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxSort, 2 * kTile, false));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      topk_select<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxSort, kMergeCap, true));
}

// Scratch words (32-bit) a launch needs: two halves of (key, index) for
// every tile's k candidates; none when one tile holds all N.
long long topk_reward_scratch_words(long long n, int k) {
  const long long tiles = n / kTile > 1 ? n / kTile : 1;
  return tiles > 1 ? 4 * tiles * (long long)k : 0;
}

// Launches the whole selection on `stream`; returns the CUDA error code
// (cudaErrorInvalidValue for k outside [1, min(N, 8192)] or too little
// scratch). `valid` is one byte per client (nonzero = selectable);
// `scratch` holds `scratch_words` 32-bit words; out_v / out_i get k
// entries.
int topk_reward_launch(const float* a, const float* b, const float* ucb,
                       const uint8_t* valid, long long n, int mode, float f,
                       float g, int k, int index_offset, uint32_t* scratch,
                       long long scratch_words, float* out_v, int* out_i,
                       void* stream) {
  if (k < 1 || k > kMaxSort || k > n ||
      scratch_words < topk_reward_scratch_words(n, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kpad = next_pow2(k);
  const long long tiles = n / kTile > 1 ? n / kTile : 1;
  const int cap = tiles == 1 ? (int)n : 2 * kTile;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(ucb);
  const int vec = (align % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(valid) % 4 == 0);
  uint32_t* out_bits = reinterpret_cast<uint32_t*>(out_v);
  const long long half = 2 * tiles * (long long)k;  // words a half

  topk_select<true><<<(unsigned)tiles, kThreads,
                      smem_bytes(kpad, cap, false), s>>>(
      a, b, ucb, valid, vec, nullptr, nullptr, n, kTile, cap, mode, f, g, k,
      kpad, tiles == 1, index_offset, tiles == 1 ? out_bits : scratch,
      tiles == 1 ? out_i : reinterpret_cast<int*>(scratch) + half / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int per_group = kMergeCap / k;
  if (per_group < 2) per_group = 2;
  const int group_len = per_group * k;
  long long m = tiles * (long long)k;
  for (int level = 0; m > k; ++level) {
    const long long groups = (m + group_len - 1) / group_len;
    const uint32_t* src = scratch + (level % 2) * half;
    uint32_t* dst = scratch + ((level + 1) % 2) * half;
    topk_select<false><<<(unsigned)groups, kThreads,
                         smem_bytes(kpad, group_len, true), s>>>(
        nullptr, nullptr, nullptr, nullptr, 0, src,
        reinterpret_cast<const int*>(src) + half / 2, m, group_len,
        group_len, mode, f, g, k, kpad, groups == 1, index_offset,
        groups == 1 ? out_bits : dst,
        groups == 1 ? out_i : reinterpret_cast<int*>(dst) + half / 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    m = groups * (long long)k;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
