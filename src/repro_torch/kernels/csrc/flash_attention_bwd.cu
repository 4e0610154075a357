// Causal / full softmax attention backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference (src/repro/models/attention.py)
// differentiates its pure-jnp attention, and the TPU forward kernel
// (src/repro/kernels/flash_attention.py, _flash_kernel) has no backward.
// The port's forward is a kernel whose output carries no autograd graph, so
// its gradient needs a kernel of its own: this one computes, for the
// forward of flash_attention.cu (scale D^-0.5, causal mask at -1e30),
//
//   P  = exp(s * scale - lse)          s = q k^T, lse saved by the forward
//   dV = P^T dO                        (natural base, f32, one per row)
//   Di = rowsum(dO o O)
//   dS = P o (dO V^T - D)
//   dQ = scale dS K,   dK = scale dS^T Q
//
// with dK and dV summed over the G = H / KH query heads of each KV head
// (grouped-query attention), all in f32; outputs in the input type (bf16
// or f32). Layouts as the forward's: q, o, dO (B, S, H, D) and k, v
// (B, S, KH, D) read through their batch / sequence / head strides (the
// last dimension contiguous); dq (B, S, H, D) and dk, dv (B, S, KH, D)
// written contiguous.
//
// Bound on an H100 SXM, at the olmo-1b train step's shape B = 4, S = 4096,
// H = KH = 16, D = 128, causal: five products over the B*H*S^2/2 pairs the
// mask keeps (s recomputed, dP, dV, dK, dQ), 10 * 68.7 G = 687 GFLOP, 0.695
// ms at 989 TFLOP/s of bf16 tensor-core work; q, k, v, o, dO, dq, dk, dv in
// bf16 are 537 MB, 0.16 ms at 3.35 TB/s: bound by operations, so the five
// products must run on wgmma, the only way to the card's full bf16 rate,
// with their operands fed by TMA and the softmax work hidden behind them.
//
// Three launches:
//   1. bwd_prep: one warp a (batch, row, head): D = rowsum(dO o O) into an
//      f32 (B, H, S) buffer, and the row of dq's f32 accumulator zeroed.
//   2. the main kernel: one CTA per (KV head of a batch, key tile), the
//      tiles with the most query tiles under the causal mask (the first
//      keys) launched first. K and V stay in shared memory; dK and dV
//      accumulate in f32 registers while the CTA loops over the G query
//      heads of its KV head and, for each, over the 64-row query tiles
//      from the diagonal on (all of them without the mask): so the GQA sum
//      needs no atomics. dQ is a sum over key tiles, so CTAs add their
//      shares into dq's f32 accumulator. Keys and queries past S load as
//      zeros; pairs with a key or query past S get P = dS = 0; dK, dV rows
//      past S are not written.
//   3. cast_dq (bf16 only): dq's f32 accumulator to bf16. An f32 dq is
//      accumulated in place.
//
// flash_bwd_wgmma (bf16, D = 64 or 128; base pointers and strides 16-byte
// aligned, which the wrapper checks): a warp-specialised Hopper kernel
// over 128-key tiles, 384 threads, 198,696 bytes of shared memory at D =
// 128 (one CTA an SM).
//   - Warpgroup 0 gives up its registers (setmaxnreg 24); its first thread
//     issues the copies by TMA through CUtensorMaps that the launch
//     function encodes per call over the strided 4-d tensors (q, dO: {D,
//     H, S, B}; k, v: {D, KH, S, B}; 128-byte swizzled boxes of 64 columns,
//     two at D = 128). K and V of the tile are loaded once; the (query
//     head, 64-row query tile) pairs stream Q and dO through a ring of 2
//     stages with full and empty mbarriers, and the producer warp's lanes
//     put each tile's lse * log2 e and D beside them (0 past S).
//   - Two consumer warpgroups (setmaxnreg 240: 2 x 128 x 240 + 128 x 24 <=
//     65,536) own 64 keys each. On every stage: S^T = K Q^T and dP^T = V
//     dO^T as wgmma m64n64k16 with both operands in shared memory
//     (K-major); P^T = 2^(s scale log2 e - lse log2 e) (ex2.approx) and
//     dS^T = P^T o (dP^T - D) on the f32 accumulator fragments; P^T and
//     dS^T rounded to bf16 in registers as the A operands of dV += P^T dO
//     and dK += dS^T Q (wgmma m64nDk16, dO and Q read as MN-major B
//     operands), as the forward rounds P before P V. dK and dV (2 x D / 2
//     f32 a thread) stay in registers over the whole loop.
//   - Masks: only tiles that straddle the diagonal or pass S are masked,
//     and by integer operations alone: a thread's kept pairs of a key row
//     form one interval of query columns, a 64-bit mask from which each
//     pair's exponent is set to -inf. A predicate a pair, or a trap in the
//     mbarrier waits' loop (mbar_wait_bounded gives up instead), cost
//     ptxas enough registers beside the 192 of the accumulators that it
//     spilled dK and dV around every product and serialized the wgmmas.
//   - dQ: each consumer also stores its dS^T (bf16, keys x queries) into a
//     128-byte-swizzled tile (two, alternating by stage), fences it for
//     the async proxy and meets the other consumer at a named barrier
//     (the producer is not in it). Then each warpgroup computes a 64 x 64
//     dQ partial with dS read through an M-major descriptor (the
//     transpose 16-bit operands allow) and K as an N-major one, in the
//     registers S^T and dP^T had: at D = 128 columns 64 w .. 64 w + 63 over
//     all 128 keys, at D = 64 all columns over its own 64 keys. It writes
//     the partial (times the scale) as two swizzled f32 boxes to its own
//     shared buffer, fences it, and one thread adds each box into dq's
//     accumulator with a TMA bulk reduce-add (cp.reduce.async.bulk.tensor
//     ... add on an f32 map of the accumulator): two instructions where
//     the mma.sync design before it issued 64 x 128 atomics a tile pair.
//     The thread waits for the bulk group to have read its buffer before
//     the buffer is written again. The additions into dq arrive in no
//     fixed order, so dq's f32 sums (and at times its bf16 rounding) vary
//     from run to run; dk and dv do not.
//   - The stage's empty barrier is released once the products that read
//     its Q and dO are complete (wgmma.wait_group 1: dQ reads K and dS
//     only).

// flash_bwd (f32): scalar f32 FMAs, 256 threads: each thread a 4 x 4 block
// of S^T and dP^T (one pass over d for both) and a 4 x D/16 block of dK,
// dV and dQ; P^T and dS^T through shared memory. At most 67 TFLOP/s of
// f32, about a third of it reachable with one shared-memory load per two
// FMAs.

#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows a tile
constexpr int kBK = 64;           // key rows a CTA
constexpr int kLP = kBQ + 1;      // padded row of the P^T and dS^T tiles
constexpr int kPrepWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp a (b, s, h) row, rows in (B, S, H) order.
template <typename T>
__global__ void __launch_bounds__(32 * kPrepWarps)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dO,
         float* __restrict__ delta, float* __restrict__ dq_acc, int B, int S,
         int H, int D, Strides os, Strides dos) {
  const long long row =
      (long long)blockIdx.x * kPrepWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * S * H) return;
  const int h = (int)(row % H);
  const int s = (int)((row / H) % S);
  const int b = (int)(row / ((long long)H * S));
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dO + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
  float* qrow = dq_acc + row * D;  // contiguous (B, S, H, D)
  for (int d = lane; d < D; d += 32) qrow[d] = 0.f;
}

template <int HD>
constexpr int smem_bytes() {
  return ((kBK + kBK + kBQ + kBQ) * (HD + 1) + 2 * kBK * kLP + 2 * kBQ) * 4;
}

// f32 inputs; grid (B * KH, key tiles); blockIdx.y = 0 holds the first
// keys
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq_acc, float* __restrict__ dk,
          float* __restrict__ dv, int S, int H, int KH, Strides qs,
          Strides ks, Strides vs, Strides dos, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CJ = HD / 16;  // d columns a thread
  extern __shared__ float smem[];
  float* sk = smem;               // [kBK][LD]
  float* sv = sk + kBK * LD;      // [kBK][LD]
  float* sq = sv + kBK * LD;      // [kBQ][LD]
  float* sdo = sq + kBQ * LD;     // [kBQ][LD]
  float* sp = sdo + kBQ * LD;     // [kBK][kLP]: P^T
  float* sds = sp + kBK * kLP;    // [kBK][kLP]: dS^T
  float* slse = sds + kBK * kLP;  // [kBQ]
  float* sdelta = slse + kBQ;     // [kBQ]

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kBK;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = k0 + r;
    const bool ok = t < S;
    sk[r * LD + d] = ok ? kb[t * ks.s + d] : 0.f;
    sv[r * LD + d] = ok ? vb[t * vs.s + d] : 0.f;
  }

  // rows (keys) rg + 16 i, columns (d) cg + 16 j
  float dk_acc[4][CJ], dv_acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int qt0 = causal ? k0 / kBQ : 0;  // query tiles above it see no key
  const int n_qt = (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dO + b * dos.b + h * dos.h;
    const float* lseb = lse + ((long long)b * H + h) * S;
    const float* deltab = delta + ((long long)b * H + h) * S;
    float* dqb = dq_acc + ((long long)b * S * H + h) * HD;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the last tile's readers are done (and sk, sv set)
      for (int i = tid; i < kBQ * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, t = q0 + r;
        const bool ok = t < S;
        sq[r * LD + d] = ok ? qb[t * qs.s + d] : 0.f;
        sdo[r * LD + d] = ok ? dob[t * dos.s + d] : 0.f;
      }
      if (tid < kBQ) {
        const int t = q0 + tid;
        slse[tid] = t < S ? lseb[t] : 0.f;
        sdelta[tid] = t < S ? deltab[t] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys rg + 16 i x queries cg + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sk[(rg + 16 * i) * LD + d];
          vv[i] = sv[(rg + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sq[(cg + 16 * j) * LD + d];
          gv[j] = sdo[(cg + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
          }
      }
      // P^T and dS^T; masked pairs and rows or keys past S give exactly 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j, row = q0 + c;
          float p = 0.f;
          if (key < S && row < S && (!causal || key <= row))
            p = expf(fmaf(st[i][j], scale, -slse[c]));
          sp[(rg + 16 * i) * kLP + c] = p;
          sds[(rg + 16 * i) * kLP + c] = p * (dpt[i][j] - sdelta[c]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (the scale at the end)
#pragma unroll 2
      for (int c = 0; c < kBQ; ++c) {
        float pv[4], sv_[4], gv[CJ], qv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sp[(rg + 16 * i) * kLP + c];
          sv_[i] = sds[(rg + 16 * i) * kLP + c];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          gv[j] = sdo[c * LD + cg + 16 * j];
          qv[j] = sq[c * LD + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv_[i], qv[j], dk_acc[i][j]);
          }
      }

      // dQ += scale dS K: queries rg + 16 i x d cg + 16 j, into the f32
      // accumulator
      float dq[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dq[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kBK; ++c) {
        float sv_[4], kv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv_[i] = sds[c * kLP + rg + 16 * i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) kv[j] = sk[c * LD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) dq[i][j] = fmaf(sv_[i], kv[j], dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg + 16 * i;
        if (row >= S) continue;
        float* dqr = dqb + (long long)row * H * HD;
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          atomicAdd(dqr + cg + 16 * j, dq[i][j] * scale);
      }
    }
  }

  // dk, dv: contiguous (B, S, KH, HD)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * KH + kh) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dk[off + cg + 16 * j] = dk_acc[i][j] * scale;
      dv[off + cg + 16 * j] = dv_acc[i][j];
    }
  }
}

// ----------------------------------------------- tensor-core bf16 path
using bf16 = __nv_bfloat16;

template <int HD>
struct WgTraits {
  static constexpr int kBK = 128;             // keys a CTA, 64 a consumer
  static constexpr int kBQ = 64;              // query rows a stage
  static constexpr int kWGs = 2;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kWGs + 1);   // + the producer's
  static constexpr int kConsumerRegs = 240;
  static constexpr int kStages = 2;           // Q / dO ring depth
  static constexpr int kBlocks = HD / kBox;   // 64-column boxes a row
  static constexpr int kKVBox = kBK * 128;    // a 128-row box: 16 KB
  static constexpr int kQBox = kBQ * 128;     // a 64-row box: 8 KB
  static constexpr int kKVTile = kBlocks * kKVBox;
  static constexpr int kQTile = kBlocks * kQBox;
  static constexpr int kDS = kBK * kBQ * 2;   // dS^T, keys x queries, bf16
  static constexpr int kDQBox = 64 * 32 * 4;  // 64 rows x 32 f32 columns
  static constexpr int kDQ = 2 * kDQBox;      // a consumer's 64 x 64 partial
  static constexpr int kDqSteps = HD == 128 ? 8 : 4;  // its k-steps of 16 keys
  // byte offsets from the 1 KB-aligned base: K, V, the Q and dO stages,
  // two dS^T tiles, the consumers' dQ partials, each stage's lse * log2 e
  // and D (64 f32 each), the mbarriers; + 1 KB to align the base
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kDSOff = kDO + kStages * kQTile;
  static constexpr int kDQOff = kDSOff + 2 * kDS;
  static constexpr int kVec = kDQOff + kWGs * kDQ;
  static constexpr int kBar = kVec + kStages * 2 * kBQ * 4;
  static constexpr int kSmemBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// the bits u of [lo, hi), lo and hi clamped to [0, 64]
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 64);
  if (hi <= lo) return 0ull;
  const uint64_t below_hi = hi == 64 ? ~0ull : (1ull << hi) - 1ull;
  return below_hi & ~((1ull << lo) - 1ull);
}
// x where bit u of keep is set, else -inf (2^-inf = 0), by integer ops
// alone (no predicate a pair)
__device__ __forceinline__ float keep_or_neg_inf(float x, uint64_t keep,
                                                 int u) {
  const int m = -static_cast<int>((keep >> u) & 1ull);
  return __int_as_float((__float_as_int(x) & m) | (~m & 0xff800000));
}

// grid (B * KH, key tiles); blockIdx.y = 0 holds the first keys
template <int HD>
__global__ void __launch_bounds__(WgTraits<HD>::kThreads, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap dqmap,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int H, int KH, float scale,
                int causal) {
  using T = WgTraits<HD>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + T::kVec);
  const uint32_t sk = base + T::kK, sv = base + T::kV, sq = base + T::kQ;
  const uint32_t sdo = base + T::kDO, sds = base + T::kDSOff;
  const uint32_t sdq = base + T::kDQOff, bars = base + T::kBar;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH, G = H / KH;
  const int k0 = blockIdx.y * T::kBK;
  const int qt0 = causal ? k0 / T::kBQ : 0;  // query tiles above it see no key
  const int n_qt = (S + T::kBQ - 1) / T::kBQ - qt0;  // a head's query tiles
  const int n_it = G * n_qt;                          // stages of the CTA

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 33);  // the copies' expect_tx + the producer lanes
      mbar_init(empty(s), 4 * T::kWGs);  // each consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * T::kKVTile);
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load(sk + c * T::kKVBox, &kmap, full_kv, c * kBox, kh, k0, b);
          tma_load(sv + c * T::kKVBox, &vmap, full_kv, c * kBox, kh, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
        if (it >= kStages)
          mbar_wait_bounded(empty(st), ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(st), 2 * T::kQTile);
          for (int c = 0; c < T::kBlocks; ++c) {
            tma_load(sq + st * T::kQTile + c * T::kQBox, &qmap, full(st),
                     c * kBox, h, q0, b);
            tma_load(sdo + st * T::kQTile + c * T::kQBox, &domap, full(st),
                     c * kBox, h, q0, b);
          }
        }
        // the tile's log-sum-exp (times log2 e) and D; rows past S as 0
        const long long row = ((long long)b * H + h) * S;
        float* sl = vec + st * 2 * T::kBQ;
        for (int r = lane; r < T::kBQ; r += 32) {
          const int t = q0 + r;
          sl[r] = t < S ? lse[row + t] * kLog2e : 0.f;
          sl[T::kBQ + r] = t < S ? delta[row + t] : 0.f;
        }
        mbar_arrive(full(st));
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::kConsumerRegs)
                 : "memory");
    // keys 64 wg .. 64 wg + 63; read through a shuffle so that the
    // compiler knows it is uniform across the warp and keeps the shared
    // addresses and descriptors that derive from it in uniform registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;        // fragment row, col pair
    const int key0 = 64 * wg + 16 * warp + g;    // rows key0, key0 + 8
    const float scale_log2 = scale * kLog2e;
    // K, V: the warpgroup's 64 rows of each 64-column box, K-major
    const uint32_t ka = sk + wg * 64 * 128, va = sv + wg * 64 * 128;
    // dQ: the partial's columns in dq and its k-steps' 16-key offset
    const int dq_col = HD == 128 ? 64 * wg : 0;
    const int ks0 = HD == 128 ? 0 : 4 * wg;
    const uint32_t kb = sk + (HD == 128 ? wg * T::kKVBox : 0);
    const uint32_t qb = sdq + wg * T::kDQ;

    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait_bounded(full_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
      const uint32_t qa = sq + st * T::kQTile, da = sdo + st * T::kQTile;
      // opaque each stage, so that the descriptors of K and V are built at
      // their products, not hoisted out of the loop and held in registers
      uint32_t kas = ka, vas = va, kbs = kb;
      asm volatile("" : "+r"(kas), "+r"(vas), "+r"(kbs));
      mbar_wait_bounded(full(st), ph);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, HD / 16
      // k-steps of 32 bytes in a box; then dQ in the same registers
      float acc[64];
      float(&s)[32] = *reinterpret_cast<float(*)[32]>(acc);
      float(&dp)[32] = *reinterpret_cast<float(*)[32]>(acc + 32);
      pin(s);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        wgmma_ss_n64<0, 0>(s, wg_desc(kas + (kk / 4) * T::kKVBox + col, 16,
                                      1024),
                           wg_desc(qa + (kk / 4) * T::kQBox + col, 16, 1024),
                           kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dp, wg_desc(vas + (kk / 4) * T::kKVBox + col, 16,
                                       1024),
                           wg_desc(da + (kk / 4) * T::kQBox + col, 16, 1024),
                           kk > 0);
      }
      wg_commit();
      wg_wait0();
      pin(s);
      pin(dp);

      // P^T and dS^T in base 2, rows keys key0 (+8), columns queries u = 8 j
      // + 2 c (+1): P = 2^(s scale log2 e - lse log2 e), dS = P (dP - D).
      // On tiles that straddle the diagonal or pass S, a masked pair's
      // exponent is -inf, so that its P and dS are 0: keep bit u - 2 c of
      // row hr (key key0 + 8 hr) for u - 2 c in [lo, hi), lo from the
      // diagonal, hi from S (0 for a key past S).
      const float* sl = vec + st * 2 * T::kBQ;
      const bool edge = (causal && k0 + 64 * wg + 63 > q0) ||
                        k0 + 64 * wg + 64 > S || q0 + T::kBQ > S;
      uint64_t keep[2] = {~0ull, ~0ull};
      if (edge) {
        const int dkr = k0 + key0 - q0 - 2 * c;  // key - query at u = 2 c
        const int rlim = S - q0 - 2 * c;          // query < S: u - 2 c < rlim
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          keep[hr] = bit_range(causal ? dkr + 8 * hr : 0,
                               k0 + key0 + 8 * hr < S ? rlim : 0);
      }
      // P^T and dS^T rounded to bf16 as the A fragments of P^T dO and dS^T
      // Q (k-steps of 16 queries), as the forward rounds P before P V; dS^T
      // also into this stage's tile of 128 key rows of 64 queries (128
      // bytes), 16-byte chunk j of row r at chunk j ^ (r % 8), as the
      // 128-byte swizzle reads it. Each 8 queries are read, computed and
      // stored before the next, so that few registers beyond the
      // accumulators are live.
      const uint32_t dsb = sds + (it & 1) * T::kDS;
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* lj = sl + 8 * j + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(lj);
        const float2 dl = *reinterpret_cast<const float2*>(lj + T::kBQ);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = e & 1;
          float x = fmaf(s[i], scale_log2, -(col ? l2.y : l2.x));
          if (edge) x = keep_or_neg_inf(x, keep[e >> 1], 8 * j + col);
          const float pv = ex2(x);
          s[i] = pv;
          dp[i] = pv * (dp[i] - (col ? dl.y : dl.x));
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = key0 + 8 * hr, r = 2 * (j & 1) + hr;
          pa[j / 2][r] = pack_bf16(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]);
          sa[j / 2][r] =
              pack_bf16(dp[4 * j + 2 * hr], dp[4 * j + 2 * hr + 1]);
          st_shared(dsb + key * 128 + ((j ^ (key & 7)) << 4) + 4 * c,
                    sa[j / 2][r]);
        }
      }
      fence_async_smem();

      // dV += P^T dO, dK += dS^T Q (the scale at the end): dO and Q
      // MN-major, 16 queries = two 8-row groups (1 KB apart) a k-step, the
      // 64-column boxes a Q tile apart
      pin(dva);
      pin(dka);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        pin(pa[kq]);
        pin(sa[kq]);
      }
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t row = kq * 16 * 128;
        wgmma_rs<HD>(dva, pa[kq], wg_desc(da + row, T::kQBox, 1024));
        wgmma_rs<HD>(dka, sa[kq], wg_desc(qa + row, T::kQBox, 1024));
      }
      wg_commit();

      // both consumers' dS^T in the tile: dQ (64 queries x 64 columns) =
      // dS K, dS read M-major and K N-major, k-steps of 16 keys
      bar_sync(1, 128 * T::kWGs);
      float(&dq)[32] = *reinterpret_cast<float(*)[32]>(acc);
      pin(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < T::kDqSteps; ++kk) {
        const int ks = ks0 + kk;
        wgmma_ss_n64<1, 1>(dq, wg_desc(dsb + ks * 2048, T::kDS, 1024),
                           wg_desc(kbs + ks * 2048, T::kKVBox, 1024), kk > 0);
      }
      wg_commit();
      wg_wait1();  // dV and dK done: the stage's Q and dO are free
      pin(dva);
      pin(dka);
      if (lane == 0) mbar_arrive(empty(st));
      wg_wait0();
      pin(dq);

      // the partial (times the scale) into the warpgroup's buffer, once the
      // last reduce-add has read it: two boxes of 64 rows x 32 f32
      // (128-byte rows, 16-byte chunk k of row r at k ^ (r % 8))
      if (tid == 0) bulk_wait_read0();
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * warp + g + 8 * hr;
          const int chunk = 2 * (j % 4) + (c >> 1);
          st_shared(qb + (j / 4) * T::kDQBox + r * 128 +
                        ((chunk ^ g) << 4) + 8 * (c & 1),
                    dq[4 * j + 2 * hr] * scale,
                    dq[4 * j + 2 * hr + 1] * scale);
        }
      fence_async_smem();
      bar_sync(2 + wg, 128);
      if (tid == 0) {
        tma_reduce_add(&dqmap, qb, dq_col, h, q0, b);
        tma_reduce_add(&dqmap, qb + T::kDQBox, dq_col + 32, h, q0, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait0();

    // dk, dv: contiguous (B, S, KH, HD); rows key0 and key0 + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + key0 + 8 * hr;
      if (key >= S) continue;
      const long long off = (((long long)b * S + key) * KH + kh) * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(
            dka[4 * j + 2 * hr] * scale, dka[4 * j + 2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
      }
    }
  }
}

__global__ void cast_dq(const float* __restrict__ acc,
                        __nv_bfloat16* __restrict__ dq, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dq[i] = __float2bfloat16_rn(acc[i]);
}

// the shared-memory limit of `kernel` raised to `bytes` once per device
// (`ready`: the flags of one kernel)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || ready[dev]) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dO, const float* lse,
                         const float* delta, float* dq_acc, void* dk,
                         void* dv, int B, int S, int H, int KH, int causal,
                         float scale, Strides qs, Strides ks, Strides vs,
                         Strides dos, cudaStream_t stream) {
  using T = WgTraits<HD>;
  static bool ready[64] = {false};
  cudaError_t err = allow_smem(flash_bwd_wgmma<HD>, T::kSmemBytes, ready);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // dq's accumulator: contiguous (B, S, H, HD) f32, boxes of 64 rows x 32
  const Strides acc{(long long)S * H * HD, (long long)H * HD, HD};
  CUtensorMap qm, km, vm, dom, dqm;
  if (!make_map(&qm, encode, q, B, S, H, HD, T::kBQ, qs) ||
      !make_map(&km, encode, k, B, S, KH, HD, T::kBK, ks) ||
      !make_map(&vm, encode, v, B, S, KH, HD, T::kBK, vs) ||
      !make_map(&dom, encode, dO, B, S, H, HD, T::kBQ, dos) ||
      !make_map(&dqm, encode, dq_acc, B, S, H, HD, T::kBQ, acc, true))
    return cudaErrorInvalidValue;
  const dim3 grid(B * KH, (S + T::kBK - 1) / T::kBK);
  flash_bwd_wgmma<HD><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, dom, dqm, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KH, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dO, void* dq,
                   void* dk, void* dv, float* dq_acc, float* delta, int B,
                   int S, int H, int KH, int causal, float scale, Strides qs,
                   Strides ks, Strides vs, Strides os, Strides dos,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  cudaError_t err = cudaSuccess;
  if constexpr (!kBf16) {
    static bool ready[64] = {false};
    err = allow_smem(flash_bwd<HD>, smem_bytes<HD>(), ready);
    if (err != cudaSuccess) return err;
  }
  const long long rows = (long long)B * S * H;
  bwd_prep<T><<<(unsigned)((rows + kPrepWarps - 1) / kPrepWarps),
                32 * kPrepWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, dq_acc, B,
      S, H, HD, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kBf16) {
    err = launch_wgmma<HD>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B, S, H,
                           KH, causal, scale, qs, ks, vs, dos, stream);
    if (err != cudaSuccess) return err;
    const long long n = rows * HD;
    const long long blocks = (n + 255) / 256;
    cast_dq<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
              stream>>>(dq_acc, static_cast<bf16*>(dq), n);
  } else {
    const dim3 grid(B * KH, (S + kBK - 1) / kBK);
    flash_bwd<HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), S,
        H, KH, qs, ks, vs, dos, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements; q, o, dO
// (B, S, H, D) and k, v (B, S, KH, D) with their last dimension
// contiguous, and for bfloat16 their rows 16-byte aligned (base pointer
// and strides; the wrapper checks); lse and delta contiguous f32
// (B, H, S); dq, dk, dv contiguous outputs; dq_acc a contiguous f32
// (B, S, H, D) scratch, or dq itself for float32. Returns a CUDA error
// code (0 on success); cudaErrorInvalidValue for a head size or type the
// library was not built for, or strides TMA refuses; cudaErrorNotSupported
// where cuTensorMapEncodeTiled cannot be found.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* dq_acc, void* delta, int B, int S, int H, int KH, int D, int dtype,
    int causal, float scale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, l, dO, dq, dk, dv, acc, dl, B, S, H,
                             KH, causal, scale, qs, ks, vs, os, dos, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, l, dO, dq, dk, dv, acc, dl, B, S,
                              H, KH, causal, scale, qs, ks, vs, os, dos, st);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, o, l, dO, dq, dk, dv, acc, dl, B, S, H,
                            KH, causal, scale, qs, ks, vs, os, dos, st);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, o, l, dO, dq, dk, dv, acc, dl, B, S,
                             H, KH, causal, scale, qs, ks, vs, os, dos, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
