// Fused EAFL reward + exact top-k client selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py
// (_topk_kernel, topk_reward): per client a fused score
//     eafl      f*a + (1-f)*b      (one fused multiply-add, see below)
//     oort      a
//     eafl-epj  a / max(b, 1e-3)
// times (1 + ucb), SENTINEL (-3e38) outside `valid`, then the k best
// clients. The result equals a global stable top-k: values descending,
// ties lowest index first, which is lax.top_k's order and the blocked
// reference kernel's merged order.
//
// Bound: the function reads 13 bytes per client (three f32 arrays and a
// one-byte mask; 9 without ucb) and writes 8*k bytes. At 1,048,576 clients
// that is 13.6 MB, about 4.1 us at the H100 SXM's 3.35 TB/s; at 10,000
// clients it is launch-bound. This first design is correct and simple,
// not at that bound:
//   pass 1: one CTA per block of `block_n` clients loads the block once
//           (coalesced, each input byte read once), scores it into shared
//           memory and emits the block's top-k by k rounds of a block
//           argmax on (value desc, index asc). Each thread caches the best
//           of its own slots, so a round costs one warp-shuffle reduction,
//           one cross-warp reduction in shared memory, and a rescan by the
//           one thread whose slot won.
//   pass 2+: the same argmax rounds merge groups of candidate lists held
//           in shared memory, level by level, until one list of k is left.
//           At 4M clients and k = 100 that is 102,400 candidates: too many
//           for one CTA, hence the levels.
// Rounds are sequential in k; a radix select or fewer rounds is the next
// step for speed.
//
// Float semantics: build with -fmad=false. The eafl mix is evaluated as
// float(double(f)*double(a) + double(float(g*b))): the f32 product f*a is
// exact in double, so this is the fused multiply-add that the reference's
// compiler emits for f*a + g*b, and it is the expression the plain PyTorch
// version evaluates, bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kIdxNone = 0x7fffffff;
constexpr float kSentinel = -3e38f;
constexpr int kPass1Threads = 256;
constexpr int kMergeThreads = 1024;
constexpr int kMergeCapacity = 16384;  // candidates held by one merge CTA

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
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

// Best (value desc, index asc) over the slots p = t, t+T, ... of one thread.
__device__ __forceinline__ void own_best(const float* sv, const int* si,
                                         int len, int t, int T, float& bv,
                                         int& bi, int& bp) {
  bv = -CUDART_INF_F;
  bi = kIdxNone;
  bp = -1;
  for (int p = t; p < len; p += T) {
    if (better(sv[p], si[p], bv, bi)) {
      bv = sv[p];
      bi = si[p];
      bp = p;
    }
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i, int& p) {
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, o);
    int i2 = __shfl_down_sync(0xffffffffu, i, o);
    int p2 = __shfl_down_sync(0xffffffffu, p, o);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
      p = p2;
    }
  }
}

// One CTA reduces one group of `group_len` entries to its k best.
// FIRST: entries are clients scored from (a, b, ucb, valid);
// otherwise: entries are (in_v, in_i) candidates of the previous level.
// Slots past `n_in` and taken winners hold (-inf, kIdxNone), so they sort
// after every real entry and a winner is never taken twice.
template <bool FIRST>
__global__ void topk_level(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ ucb,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ in_v,
                           const int* __restrict__ in_i, long long n_in,
                           int group_len, int mode, float f, float g, int k,
                           int index_offset, float* __restrict__ out_v,
                           int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* sv = smem;
  int* si = reinterpret_cast<int*>(smem + group_len);
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ int wp[32];
  __shared__ int win_p;

  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
  const long long start = (long long)blockIdx.x * group_len;

  for (int p = t; p < group_len; p += T) {
    const long long q = start + p;
    float v = -CUDART_INF_F;
    int id = kIdxNone;
    if (q < n_in) {
      if (FIRST) {
        v = kSentinel;
        if (valid[q] != 0) {
          v = score(mode, a[q], b[q], f, g);
          if (ucb != nullptr) v = __fmul_rn(v, __fadd_rn(1.0f, ucb[q]));
        }
        id = (int)q;
      } else {
        v = in_v[q];
        id = in_i[q];
      }
    }
    sv[p] = v;
    si[p] = id;
  }
  // each thread only reads back its own slots here, so no barrier yet
  float bv;
  int bi, bp;
  own_best(sv, si, group_len, t, T, bv, bi, bp);

  for (int r = 0; r < k; ++r) {
    float v = bv;
    int i = bi, p = bp;
    warp_best(v, i, p);
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = i;
      wp[warp] = p;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < n_warps ? wv[lane] : -CUDART_INF_F;
      i = lane < n_warps ? wi[lane] : kIdxNone;
      p = lane < n_warps ? wp[lane] : -1;
      warp_best(v, i, p);
      if (lane == 0) {
        const long long o = (long long)blockIdx.x * k + r;
        out_v[o] = v;
        out_i[o] = (i == kIdxNone) ? i : i + index_offset;
        win_p = p;
      }
    }
    __syncthreads();
    const int wpos = win_p;
    if (wpos >= 0 && wpos % T == t) {
      sv[wpos] = -CUDART_INF_F;
      si[wpos] = kIdxNone;
      own_best(sv, si, group_len, t, T, bv, bi, bp);
    }
  }
}

}  // namespace

extern "C" {

// Raises both kernels' dynamic shared-memory limit to the most a launch
// can ask for (pass 1: max_block_n clients; merges: kMergeCapacity
// candidates; 8 bytes each). Call once per device before the first
// launch; returns the CUDA error code.
int topk_reward_init(int max_block_n) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_level<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_block_n * 8);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(topk_level<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMergeCapacity * 8);
}

// Candidate slots needed in each of the two scratch halves.
long long topk_reward_scratch_len(long long n, int k, int block_n) {
  long long n_blocks = (n + block_n - 1) / block_n;
  return n_blocks * (long long)k;
}

// Launches the whole selection on `stream`; returns cudaGetLastError().
// scratch_v / scratch_i hold 2 * topk_reward_scratch_len(...) entries;
// `valid` is one byte per client (nonzero = selectable).
int topk_reward_launch(const float* a, const float* b, const float* ucb,
                       const uint8_t* valid, long long n, int mode, float f,
                       float g, int k, int block_n, int index_offset,
                       float* scratch_v, int* scratch_i, float* out_v,
                       int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long half = topk_reward_scratch_len(n, k, block_n);
  const long long n_blocks = (n + block_n - 1) / block_n;

  const size_t smem1 = (size_t)block_n * 8;
  float* dst_v = n_blocks == 1 ? out_v : scratch_v;
  int* dst_i = n_blocks == 1 ? out_i : scratch_i;
  topk_level<true><<<(unsigned)n_blocks, kPass1Threads, smem1, s>>>(
      a, b, ucb, valid, nullptr, nullptr, n, block_n, mode, f, g, k,
      n_blocks == 1 ? index_offset : 0, dst_v, dst_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int per_group = kMergeCapacity / k;
  if (per_group < 2) per_group = 2;
  const int group_len = per_group * k;
  const size_t smem2 = (size_t)group_len * 8;

  long long m = n_blocks * (long long)k;
  int level = 0;
  while (m > k) {
    const long long groups = (m + group_len - 1) / group_len;
    const float* src_v = scratch_v + (level % 2) * half;
    const int* src_i = scratch_i + (level % 2) * half;
    float* nv = groups == 1 ? out_v : scratch_v + ((level + 1) % 2) * half;
    int* ni = groups == 1 ? out_i : scratch_i + ((level + 1) % 2) * half;
    topk_level<false><<<(unsigned)groups, kMergeThreads, smem2, s>>>(
        nullptr, nullptr, nullptr, nullptr, src_v, src_i, m, group_len, mode,
        f, g, k, groups == 1 ? index_offset : 0, nv, ni);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    m = groups * (long long)k;
    ++level;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
