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
// or f32). Layouts as the forward's: q (B, S, H, Dqk), k (B, S, KH, Dqk),
// v (B, S, KH, Dv) and o, dO (B, S, H, Dv) read through their batch /
// sequence / head strides (the last dimension contiguous); dq (B, S, H,
// Dqk), dk (B, S, KH, Dqk) and dv (B, S, KH, Dv) written contiguous. The
// q.k width Dqk and the v width Dv differ under multi-head latent attention
// (minicpm3-4b: 96 and 64; deepseek-v2-236b: 192 and 128); the scale is
// Dqk^-0.5, and D = rowsum(dO o O) runs over Dv. The library is built for
// the forward's (Dqk, Dv) pairs (FA_PAIRS).
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
// flash_bwd_wgmma (bf16; base pointers and strides 16-byte aligned, which
// the wrapper checks): a warp-specialised Hopper kernel over 128-key
// tiles, 384 threads, 198,696 bytes of shared memory at (128, 128) (one
// CTA an SM).
//   - Warpgroup 0 gives up its registers (setmaxnreg 24); its first thread
//     issues the copies by TMA through CUtensorMaps that the launch
//     function encodes per call over the strided 4-d tensors (q: {Dqk, H,
//     S, B}; dO: {Dv, H, S, B}; k: {Dqk, KH, S, B}; v: {Dv, KH, S, B};
//     128-byte swizzled boxes of 64 columns, two at a width of 96 or 128;
//     a box's columns past the width arrive as zeros, as in the forward).
//     K and V of the tile are loaded once; the (query
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
//     operands), as the forward rounds P before P V. dK and dV (Dqk and
//     Dv padded to 64 or 128, halved, f32 a thread) stay in registers over
//     the whole loop. S^T and dP^T run only their true k-steps (Dqk / 16,
//     Dv / 16); dV, dK and dQ run over the padded widths, on zeros past
//     the true ones, and only the true columns are stored (dQ's reduce-add
//     drops the columns past the map's width).
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
//     registers S^T and dP^T had: at a padded Dqk of 128 columns 64 w .. 64
//     w + 63 over all 128 keys, at 64 all columns over its own 64 keys.
//     It writes
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

// flash_bwd_wgmma_wide (bf16 at (192, 128), deepseek-v2-236b's MLA: q.k
// 128 nope + 64 rope, three 64-column boxes a q / k row, v two). At the
// train step's B = 4, S = 4096, H = KH = 128, causal: five products over
// 4,296,015,872 kept pairs at 2 x (192 + 128 + 128 + 192 + 192) FLOP a
// pair, 7.149 TFLOP, 7.228 ms at 989 TFLOP/s; the bytes take about 2.6 ms:
// bound by operations. flash_bwd_wgmma's layout does not fit: a consumer
// warpgroup's 64 keys would hold dK (64 x 192 f32, 96 registers a thread),
// dV (64) and S^T, dP^T (32 each), 224 of setmaxnreg's 240 before any
// address, descriptor or A fragment. So:
//   - a CTA takes 64 keys, 384 threads: the producer warpgroup as in
//     flash_bwd_wgmma (K 3 boxes, V 2, each stage Q 3 and dO 2, 64 rows a
//     box), and two consumer warpgroups on the same 64 keys.
//   - S^T and dP^T are split by query columns: warpgroup w computes the 64
//     keys x queries 32 w .. 32 w + 31 of the stage, wgmma m64n32k16 with
//     K (V) and Q's (dO's) 32 rows as K-major operands, 12 and 8 k-steps,
//     16 + 16 registers. P^T and dS^T go to shared memory in bf16 (64 keys
//     x 64 queries, 8 KB each, 128-byte swizzled, two of each alternating
//     by stage), the warpgroup's 32 queries each, then a named barrier.
//   - dV and dK are split by column boxes over all 64 queries: warpgroup w
//     holds dV's box w and dK's box w (wgmma m64n64k16 with P^T / dS^T as
//     K-major A operands from the tiles and dO's / Q's box w MN-major),
//     32 + 32 registers; dK's box 2 is split by queries instead: each
//     warpgroup adds its own dS^T (its registers, as A fragments) times its
//     32 rows of Q's box 2, 32 registers, and the two parts are summed
//     through shared memory at the end (an MN-major operand of 32 columns,
//     half a swizzle atom, is not taken).
//   - dQ (64 queries x 192) = dS K, dS^T read M-major and K N-major:
//     warpgroup w computes dQ's box w over the 64 keys and box 2 over keys
//     32 w .. 32 w + 31, 32 + 32 registers, and sends them as four 32-column
//     f32 boxes by TMA bulk reduce-add, where the two box-2 parts add.
//   - registers a consumer thread: 96 held (dK box, dK box-2 part, dV box)
//     + 64 (dQ's parts, or S^T and dP^T) + 8 (dS^T's A fragments) = 168
//     besides addresses, under setmaxnreg's 240. ptxas -v (sm_90a) for
//     flash_bwd_wgmma_wide<192, 128>: 168 registers (the launch's 65,536 /
//     384; the consumers raise theirs to 240), 0 bytes spill stores, 0
//     bytes spill loads, and no C7511 (wgmma serialized) report.
//   - shared memory: K 24,576 + V 16,384 + two Q stages 49,152 + two dO
//     stages 32,768 + P^T and dS^T, two each, 32,768 + the dQ parts, 4
//     boxes of 8 KB a warpgroup, 65,536 + lse and D 1,024 + 5 mbarriers 40
//     + 1,024 to align = 223,272 bytes of the 232,448 allowed.
//   - grid (key tiles, B * KH): the 132 CTAs in flight work on one or two
//     heads, so that each head's Q, dO and dq accumulator (3 MB at S 4096)
//     stay in L2 while its 64 key tiles read and add into them. In the
//     other order (heads fastest, as flash_bwd_wgmma's grid) they leave
//     L2 between key tiles: 71.8 against 27.1 ms at deepseek's step.
//   - dQ's reduce-adds move 64 KB a stage (the box-2 parts twice): 24.3 ms
//     without them against 27.1 with.
//   (chip_probes.py --only attention_bwd_wide, H100 80GB HBM3 at 700 W)
//
// flash_bwd (f32): scalar f32 FMAs, 256 threads: each thread a 4 x 4 block
// of S^T and dP^T (one pass over d for both) and a 4 x D/16 block of dK,
// dV and dQ; P^T and dS^T through shared memory. At most 67 TFLOP/s of
// f32, about a third of it reachable with one shared-memory load per two
// FMAs.

#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace hopper;

// the (Dqk, Dv) pairs the library is built for: the forward's (the
// wrapper's BWD_HEAD_DIMS); in bf16, (192, 128) takes flash_bwd_wgmma_wide
#define FA_PAIRS(X) \
  X(64, 64) X(128, 128) X(96, 96) X(96, 64) X(48, 32) X(192, 128)

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows a tile
constexpr int kBK = 64;           // key rows a CTA
constexpr int kLP = kBQ + 1;      // padded row of the P^T and dS^T tiles
constexpr int kPrepWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp a (b, s, h) row, rows in (B, S, H) order: D over the Dv
// columns of dO and O, and the Dqk columns of dq's accumulator zeroed.
template <typename T>
__global__ void __launch_bounds__(32 * kPrepWarps)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dO,
         float* __restrict__ delta, float* __restrict__ dq_acc, int B, int S,
         int H, int Dqk, int Dv, Strides os, Strides dos) {
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
  for (int d = lane; d < Dv; d += 32)
    acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
  float* qrow = dq_acc + row * Dqk;  // contiguous (B, S, H, Dqk)
  for (int d = lane; d < Dqk; d += 32) qrow[d] = 0.f;
}

template <int DQK, int DV>
constexpr int smem_bytes() {
  return ((kBK + kBQ) * (DQK + 1) + (kBK + kBQ) * (DV + 1) + 2 * kBK * kLP +
          2 * kBQ) *
         4;
}

// f32 inputs; grid (B * KH, key tiles); blockIdx.y = 0 holds the first
// keys
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq_acc, float* __restrict__ dk,
          float* __restrict__ dv, int S, int H, int KH, Strides qs,
          Strides ks, Strides vs, Strides dos, float scale, int causal) {
  constexpr int LD = DQK + 1, LDV = DV + 1;
  constexpr int CQ = DQK / 16;  // q.k columns a thread (dk, dq)
  constexpr int CV = DV / 16;   // v columns a thread (dv)
  extern __shared__ float smem[];
  float* sk = smem;               // [kBK][LD]
  float* sv = sk + kBK * LD;      // [kBK][LDV]
  float* sq = sv + kBK * LDV;     // [kBQ][LD]
  float* sdo = sq + kBQ * LD;     // [kBQ][LDV]
  float* sp = sdo + kBQ * LDV;    // [kBK][kLP]: P^T
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

  for (int i = tid; i < kBK * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK, t = k0 + r;
    sk[r * LD + d] = t < S ? kb[t * ks.s + d] : 0.f;
  }
  for (int i = tid; i < kBK * DV; i += kThreads) {
    const int r = i / DV, d = i % DV, t = k0 + r;
    sv[r * LDV + d] = t < S ? vb[t * vs.s + d] : 0.f;
  }

  // rows (keys) rg + 16 i, columns (d) cg + 16 j
  float dk_acc[4][CQ], dv_acc[4][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CQ; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) dv_acc[i][j] = 0.f;
  }

  const int qt0 = causal ? k0 / kBQ : 0;  // query tiles above it see no key
  const int n_qt = (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dO + b * dos.b + h * dos.h;
    const float* lseb = lse + ((long long)b * H + h) * S;
    const float* deltab = delta + ((long long)b * H + h) * S;
    float* dqb = dq_acc + ((long long)b * S * H + h) * DQK;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the last tile's readers are done (and sk, sv set)
      for (int i = tid; i < kBQ * DQK; i += kThreads) {
        const int r = i / DQK, d = i % DQK, t = q0 + r;
        sq[r * LD + d] = t < S ? qb[t * qs.s + d] : 0.f;
      }
      for (int i = tid; i < kBQ * DV; i += kThreads) {
        const int r = i / DV, d = i % DV, t = q0 + r;
        sdo[r * LDV + d] = t < S ? dob[t * dos.s + d] : 0.f;
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
      for (int d = 0; d < DQK; ++d) {
        float kv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = sk[(rg + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = sq[(cg + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float vv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = sv[(rg + 16 * i) * LDV + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = sdo[(cg + 16 * j) * LDV + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
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
        float pv[4], sv_[4], gv[CV], qv[CQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sp[(rg + 16 * i) * kLP + c];
          sv_[i] = sds[(rg + 16 * i) * kLP + c];
        }
#pragma unroll
        for (int j = 0; j < CV; ++j) gv[j] = sdo[c * LDV + cg + 16 * j];
#pragma unroll
        for (int j = 0; j < CQ; ++j) qv[j] = sq[c * LD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < CV; ++j)
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
#pragma unroll
          for (int j = 0; j < CQ; ++j)
            dk_acc[i][j] = fmaf(sv_[i], qv[j], dk_acc[i][j]);
        }
      }

      // dQ += scale dS K: queries rg + 16 i x d cg + 16 j, into the f32
      // accumulator
      float dq[4][CQ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) dq[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kBK; ++c) {
        float sv_[4], kv[CQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv_[i] = sds[c * kLP + rg + 16 * i];
#pragma unroll
        for (int j = 0; j < CQ; ++j) kv[j] = sk[c * LD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) dq[i][j] = fmaf(sv_[i], kv[j], dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg + 16 * i;
        if (row >= S) continue;
        float* dqr = dqb + (long long)row * H * DQK;
#pragma unroll
        for (int j = 0; j < CQ; ++j)
          atomicAdd(dqr + cg + 16 * j, dq[i][j] * scale);
      }
    }
  }

  // dk: contiguous (B, S, KH, DQK), dv: (B, S, KH, DV)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= S) continue;
    const long long row = ((long long)b * S + key) * KH + kh;
#pragma unroll
    for (int j = 0; j < CQ; ++j)
      dk[row * DQK + cg + 16 * j] = dk_acc[i][j] * scale;
#pragma unroll
    for (int j = 0; j < CV; ++j) dv[row * DV + cg + 16 * j] = dv_acc[i][j];
  }
}

// ----------------------------------------------- tensor-core bf16 path
using bf16 = __nv_bfloat16;

template <int DQK, int DV>
struct WgTraits {
  static constexpr int kBK = 128;             // keys a CTA, 64 a consumer
  static constexpr int kBQ = 64;              // query rows a stage
  static constexpr int kWGs = 2;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kWGs + 1);   // + the producer's
  static constexpr int kConsumerRegs = 240;
  static constexpr int kStages = 2;           // Q / dO ring depth
  // 64-column boxes a row of q and k / of v and dO, and the widths padded
  // to whole boxes (the N of dK's / dV's products)
  static constexpr int kQKBlocks = (DQK + kBox - 1) / kBox;
  static constexpr int kVBlocks = (DV + kBox - 1) / kBox;
  static constexpr int kDQKP = kQKBlocks * kBox, kDVP = kVBlocks * kBox;
  static constexpr int kKVBox = kBK * 128;    // a 128-row box: 16 KB
  static constexpr int kQBox = kBQ * 128;     // a 64-row box: 8 KB
  static constexpr int kKTile = kQKBlocks * kKVBox;
  static constexpr int kVTile = kVBlocks * kKVBox;
  static constexpr int kQTile = kQKBlocks * kQBox;
  static constexpr int kDOTile = kVBlocks * kQBox;
  static constexpr int kDS = kBK * kBQ * 2;   // dS^T, keys x queries, bf16
  static constexpr int kDQBox = 64 * 32 * 4;  // 64 rows x 32 f32 columns
  static constexpr int kDQ = 2 * kDQBox;      // a consumer's 64 x 64 partial
  // dQ's k-steps of 16 keys: all 128 keys at a padded Dqk of 128 (a
  // warpgroup's 64 columns), the warpgroup's own 64 keys at 64
  static constexpr int kDqSteps = kDQKP == 128 ? 8 : 4;
  // byte offsets from the 1 KB-aligned base: K, V, the Q and dO stages,
  // two dS^T tiles, the consumers' dQ partials, each stage's lse * log2 e
  // and D (64 f32 each), the mbarriers; + 1 KB to align the base
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kQ = kKTile + kVTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kDSOff = kDO + kStages * kDOTile;
  static constexpr int kDQOff = kDSOff + 2 * kDS;
  static constexpr int kVec = kDQOff + kWGs * kDQ;
  static constexpr int kBar = kVec + kStages * 2 * kBQ * 4;
  static constexpr int kSmemBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && kQKBlocks <= 2 &&
                    kVBlocks <= 2 && kSmemBytes <= 232448,
                "a (Dqk, Dv) pair the tensor-core design does not take");
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
template <int DQK, int DV>
__global__ void __launch_bounds__((WgTraits<DQK, DV>::kThreads), 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap dqmap,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int H, int KH, float scale,
                int causal) {
  using T = WgTraits<DQK, DV>;
  constexpr int kStages = T::kStages;
  constexpr int DQKP = T::kDQKP, DVP = T::kDVP;
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
        mbar_expect_tx(full_kv, T::kKTile + T::kVTile);
        for (int c = 0; c < T::kQKBlocks; ++c)
          tma_load(sk + c * T::kKVBox, &kmap, full_kv, c * kBox, kh, k0, b);
        for (int c = 0; c < T::kVBlocks; ++c)
          tma_load(sv + c * T::kKVBox, &vmap, full_kv, c * kBox, kh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
        if (it >= kStages)
          mbar_wait_bounded(empty(st), ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(st), T::kQTile + T::kDOTile);
          for (int c = 0; c < T::kQKBlocks; ++c)
            tma_load(sq + st * T::kQTile + c * T::kQBox, &qmap, full(st),
                     c * kBox, h, q0, b);
          for (int c = 0; c < T::kVBlocks; ++c)
            tma_load(sdo + st * T::kDOTile + c * T::kQBox, &domap, full(st),
                     c * kBox, h, q0, b);
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
    const int dq_col = DQKP == 128 ? 64 * wg : 0;
    const int ks0 = DQKP == 128 ? 0 : 4 * wg;
    const uint32_t kb = sk + (DQKP == 128 ? wg * T::kKVBox : 0);
    const uint32_t qb = sdq + wg * T::kDQ;

    float dka[DQKP / 2], dva[DVP / 2];
#pragma unroll
    for (int i = 0; i < DQKP / 2; ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) dva[i] = 0.f;
    mbar_wait_bounded(full_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
      const uint32_t qa = sq + st * T::kQTile, da = sdo + st * T::kDOTile;
      // opaque each stage, so that the descriptors of K and V are built at
      // their products, not hoisted out of the loop and held in registers
      uint32_t kas = ka, vas = va, kbs = kb;
      asm volatile("" : "+r"(kas), "+r"(vas), "+r"(kbs));
      mbar_wait_bounded(full(st), ph);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, DQK / 16 and
      // DV / 16 k-steps of 32 bytes in a box; then dQ in the same registers
      float acc[64];
      float(&s)[32] = *reinterpret_cast<float(*)[32]>(acc);
      float(&dp)[32] = *reinterpret_cast<float(*)[32]>(acc + 32);
      pin(s);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        wgmma_ss_n64<0, 0>(s, wg_desc(kas + (kk / 4) * T::kKVBox + col, 16,
                                      1024),
                           wg_desc(qa + (kk / 4) * T::kQBox + col, 16, 1024),
                           kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
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
        wgmma_rs<DVP>(dva, pa[kq], wg_desc(da + row, T::kQBox, 1024));
        wgmma_rs<DQKP>(dka, sa[kq], wg_desc(qa + row, T::kQBox, 1024));
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
      // (a box wholly past Dqk, at Dqk 96, is not sent)
      if (tid == 0) {
        tma_reduce_add(&dqmap, qb, dq_col, h, q0, b);
        if (dq_col + 32 < DQK)
          tma_reduce_add(&dqmap, qb + T::kDQBox, dq_col + 32, h, q0, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait0();

    // dk: contiguous (B, S, KH, DQK), dv: (B, S, KH, DV), their true
    // columns; rows key0 and key0 + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + key0 + 8 * hr;
      if (key >= S) continue;
      const long long row = ((long long)b * S + key) * KH + kh;
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j)
        *reinterpret_cast<uint32_t*>(dk + row * DQK + 2 * c + 8 * j) =
            pack_bf16(dka[4 * j + 2 * hr] * scale,
                      dka[4 * j + 2 * hr + 1] * scale);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(dv + row * DV + 2 * c + 8 * j) =
            pack_bf16(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
    }
  }
}

// ------------------------------------ the wide pair (192, 128), bf16
template <int DQK, int DV>
struct WideTraits {
  static constexpr int kBK = 64;              // keys a CTA, both consumers'
  static constexpr int kBQ = 64;              // query rows a stage
  static constexpr int kWGs = 2;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kConsumerRegs = 240;
  static constexpr int kStages = 2;           // Q / dO ring depth
  static constexpr int kQKBlocks = DQK / kBox;   // 3 boxes a q / k row
  static constexpr int kVBlocks = DV / kBox;     // 2 a v / dO row
  static constexpr int kBoxBytes = 64 * 128;     // 64 rows of 128 bytes
  static constexpr int kKTile = kQKBlocks * kBoxBytes;  // K, or a Q stage
  static constexpr int kVTile = kVBlocks * kBoxBytes;   // V, or a dO stage
  static constexpr int kPS = kBK * kBQ * 2;   // P^T or dS^T, keys x queries
  static constexpr int kDQBox = 64 * 32 * 4;  // 64 rows x 32 f32 columns
  static constexpr int kDQ = 4 * kDQBox;      // a consumer's two dQ parts
  // byte offsets from the 1 KB-aligned base: K, V, the Q and dO stages,
  // two P^T and two dS^T tiles, the consumers' dQ parts, each stage's
  // lse * log2 e and D, the mbarriers; + 1 KB to align the base
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  static constexpr int kQ = kV + kVTile;
  static constexpr int kDO = kQ + kStages * kKTile;
  static constexpr int kPT = kDO + kStages * kVTile;
  static constexpr int kDST = kPT + 2 * kPS;
  static constexpr int kDQOff = kDST + 2 * kPS;
  static constexpr int kVec = kDQOff + kWGs * kDQ;
  static constexpr int kBar = kVec + kStages * 2 * kBQ * 4;
  static constexpr int kSmemBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(DQK == 3 * kBox && DV == 2 * kBox && kSmemBytes <= 232448,
                "the wide design takes three q.k boxes and two v boxes");
};

// grid (key tiles of 64, B * KH): the CTAs in flight share a head or two,
// whose Q, dO and dq accumulator stay in L2; blockIdx.x = 0 holds the
// first keys
template <int DQK, int DV>
__global__ void __launch_bounds__((WideTraits<DQK, DV>::kThreads), 1)
flash_bwd_wgmma_wide(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap dqmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int KH, float scale,
                     int causal) {
  using T = WideTraits<DQK, DV>;
  constexpr int kStages = T::kStages, kBB = T::kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);  // base, generic address
  float* vec = reinterpret_cast<float*>(gen + T::kVec);
  const uint32_t sk = base + T::kK, sv = base + T::kV, sq = base + T::kQ;
  const uint32_t sdo = base + T::kDO, spt = base + T::kPT;
  const uint32_t sdst = base + T::kDST, bars = base + T::kBar;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int b = blockIdx.y / KH, kh = blockIdx.y % KH, G = H / KH;
  const int k0 = blockIdx.x * T::kBK;
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
        mbar_expect_tx(full_kv, T::kKTile + T::kVTile);
        for (int c = 0; c < T::kQKBlocks; ++c)
          tma_load(sk + c * kBB, &kmap, full_kv, c * kBox, kh, k0, b);
        for (int c = 0; c < T::kVBlocks; ++c)
          tma_load(sv + c * kBB, &vmap, full_kv, c * kBox, kh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
        if (it >= kStages)
          mbar_wait_bounded(empty(st), ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(st), T::kKTile + T::kVTile);
          for (int c = 0; c < T::kQKBlocks; ++c)
            tma_load(sq + st * T::kKTile + c * kBB, &qmap, full(st),
                     c * kBox, h, q0, b);
          for (int c = 0; c < T::kVBlocks; ++c)
            tma_load(sdo + st * T::kVTile + c * kBB, &domap, full(st),
                     c * kBox, h, q0, b);
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
    // uniform across the warp (see flash_bwd_wgmma)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;        // fragment row, col pair
    const int key0 = 16 * warp + g;              // rows key0, key0 + 8
    const float scale_log2 = scale * kLog2e;
    const uint32_t qrows = wg * 32 * 128;        // the warpgroup's 32 queries
    const uint32_t qb = base + T::kDQOff + wg * T::kDQ;

    // dK's box wg and dV's box wg over all queries; dK's box 2 over the
    // warpgroup's own 32 queries of each stage (the two parts summed at
    // the end)
    float dka[32], dk2[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dk2[i] = dva[i] = 0.f;
    mbar_wait_bounded(full_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int h = kh * G + it / n_qt, q0 = (qt0 + it % n_qt) * T::kBQ;
      const int qw = q0 + 32 * wg;               // the warpgroup's queries
      const uint32_t qa = sq + st * T::kKTile, da = sdo + st * T::kVTile;
      // opaque each stage (see flash_bwd_wgmma)
      uint32_t kas = sk, vas = sv;
      asm volatile("" : "+r"(kas), "+r"(vas));
      mbar_wait_bounded(full(st), ph);  // Q and dO of the stage

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x the warpgroup's 32
      // queries, 12 and 8 k-steps of 32 bytes over the boxes (arrays of
      // their own: aliased with dQ's, as flash_bwd_wgmma's are, ptxas
      // serialized the wgmmas, 31.2 against 27.1 ms at deepseek's step)
      float s[16], dp[16];
      pin(s);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        wgmma_ss_n32(s, wg_desc(kas + (kk / 4) * kBB + col, 16, 1024),
                     wg_desc(qa + (kk / 4) * kBB + qrows + col, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n32(dp, wg_desc(vas + (kk / 4) * kBB + col, 16, 1024),
                     wg_desc(da + (kk / 4) * kBB + qrows + col, 16, 1024),
                     kk > 0);
      }
      wg_commit();
      wg_wait0();
      pin(s);
      pin(dp);

      // P^T and dS^T in base 2 as in flash_bwd_wgmma, on the warpgroup's
      // queries u = 8 j + 2 c (+1) of qw: keep bit u - 2 c of row hr for
      // u - 2 c in [lo, hi) on a tile that straddles the diagonal or
      // passes S
      const float* sl = vec + st * 2 * T::kBQ + 32 * wg;
      const bool edge = (causal && k0 + T::kBK - 1 > qw) ||
                        k0 + T::kBK > S || qw + 32 > S;
      uint64_t keep[2] = {~0ull, ~0ull};
      if (edge) {
        const int dkr = k0 + key0 - qw - 2 * c;  // key - query at u = 2 c
        const int rlim = S - qw - 2 * c;          // query < S: u - 2 c < rlim
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          keep[hr] = bit_range(causal ? dkr + 8 * hr : 0,
                               key0 + 8 * hr < S - k0 ? rlim : 0);
      }
      // both rounded to bf16 into this stage's P^T and dS^T tiles (64 key
      // rows of 64 queries, 128 bytes; 16-byte chunk j of row r at chunk j
      // ^ (r % 8), the 128-byte swizzle), the warpgroup's chunks 4 wg ..
      // 4 wg + 3; dS^T also kept as the A fragments of dK's box-2 part
      const uint32_t pt = spt + (it & 1) * T::kPS;
      const uint32_t dst = sdst + (it & 1) * T::kPS;
      uint32_t sa[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
          const int key = key0 + 8 * hr;
          const uint32_t off =
              key * 128 + (((4 * wg + j) ^ (key & 7)) << 4) + 4 * c;
          sa[j / 2][2 * (j & 1) + hr] =
              pack_bf16(dp[4 * j + 2 * hr], dp[4 * j + 2 * hr + 1]);
          st_shared(pt + off,
                    pack_bf16(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
          st_shared(dst + off, sa[j / 2][2 * (j & 1) + hr]);
        }
      }
      fence_async_smem();
      bar_sync(1, 128 * T::kWGs);  // both halves of both tiles written

      // dV's box wg += P^T dO and dK's box wg += dS^T Q over the 64
      // queries (P^T, dS^T K-major A from the tiles; dO, Q MN-major), dK's
      // box 2 += the warpgroup's dS^T (registers) x its 32 rows of Q's box
      // 2; the scale at the end
      pin(dva);
      pin(dka);
      pin(dk2);
      pin(sa[0]);
      pin(sa[1]);
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t row = kq * 16 * 128;
        wgmma_ss_n64<0, 1>(dva, wg_desc(pt + kq * 32, 16, 1024),
                           wg_desc(da + wg * kBB + row, kBB, 1024), 1);
        wgmma_ss_n64<0, 1>(dka, wg_desc(dst + kq * 32, 16, 1024),
                           wg_desc(qa + wg * kBB + row, kBB, 1024), 1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wgmma_rs_n64(dk2, sa[i],
                     wg_desc(qa + 2 * kBB + qrows + i * 16 * 128, kBB, 1024));
      wg_commit();

      // dQ (64 queries) = dS K: box wg over the 64 keys and box 2 over the
      // warpgroup's keys 32 wg .. 32 wg + 31 (dS M-major, K N-major); both
      // parts go to dq's accumulator, where the two box-2 parts add
      float dq0[32], dq1[32];
      pin(dq0);
      pin(dq1);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64<1, 1>(dq0, wg_desc(dst + ks * 2048, T::kPS, 1024),
                           wg_desc(kas + wg * kBB + ks * 2048, kBB, 1024),
                           ks > 0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t ks = (2 * wg + i) * 2048;
        wgmma_ss_n64<1, 1>(dq1, wg_desc(dst + ks, T::kPS, 1024),
                           wg_desc(kas + 2 * kBB + ks, kBB, 1024), i > 0);
      }
      wg_commit();
      wg_wait1();  // dV and dK done: the stage's Q and dO are free
      pin(dva);
      pin(dka);
      pin(dk2);
      if (lane == 0) mbar_arrive(empty(st));
      wg_wait0();
      pin(dq0);
      pin(dq1);

      // both parts (times the scale) into the warpgroup's buffer, once the
      // last reduce-adds have read it: four boxes of 64 rows x 32 f32
      // (128-byte rows, 16-byte chunk k of row r at k ^ (r % 8))
      if (tid == 0) bulk_wait_read0();
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * warp + g + 8 * hr;
          const uint32_t off = (j / 4) * T::kDQBox + r * 128 +
                               (((2 * (j % 4) + (c >> 1)) ^ g) << 4) +
                               8 * (c & 1);
          st_shared(qb + off, dq0[4 * j + 2 * hr] * scale,
                    dq0[4 * j + 2 * hr + 1] * scale);
          st_shared(qb + 2 * T::kDQBox + off, dq1[4 * j + 2 * hr] * scale,
                    dq1[4 * j + 2 * hr + 1] * scale);
        }
      fence_async_smem();
      bar_sync(2 + wg, 128);
      if (tid == 0) {
        tma_reduce_add(&dqmap, qb, 64 * wg, h, q0, b);
        tma_reduce_add(&dqmap, qb + T::kDQBox, 64 * wg + 32, h, q0, b);
        tma_reduce_add(&dqmap, qb + 2 * T::kDQBox, 2 * kBox, h, q0, b);
        tma_reduce_add(&dqmap, qb + 3 * T::kDQBox, 2 * kBox + 32, h, q0, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait0();
    bar_sync(2 + wg, 128);  // the warpgroup's dQ buffer is free

    // dK's box 2: each warpgroup stores its columns 128 + 32 wg .. 159 +
    // 32 wg (fragment groups j = 4 wg .. 4 wg + 3), its part plus the other
    // warpgroup's, passed through the dQ buffers (float2 slot (j % 4, hr)
    // of thread tid)
    float2* mine = reinterpret_cast<float2*>(gen + T::kDQOff + wg * T::kDQ);
    const float2* theirs =
        reinterpret_cast<const float2*>(gen + T::kDQOff + (1 - wg) * T::kDQ);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (j / 4 != wg)
          mine[((j % 4) * 2 + hr) * 128 + tid] =
              make_float2(dk2[4 * j + 2 * hr], dk2[4 * j + 2 * hr + 1]);
    bar_sync(1, 128 * T::kWGs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (j / 4 == wg) {
          const float2 o = theirs[((j % 4) * 2 + hr) * 128 + tid];
          dk2[4 * j + 2 * hr] += o.x;
          dk2[4 * j + 2 * hr + 1] += o.y;
        }

    // dk: contiguous (B, S, KH, DQK), dv: (B, S, KH, DV); rows key0 and
    // key0 + 8, the warpgroup's columns
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + key0 + 8 * hr;
      if (key >= S) continue;
      const long long row = ((long long)b * S + key) * KH + kh;
      bf16* dkr = dk + row * DQK + 2 * c;
      bf16* dvr = dv + row * DV + 64 * wg + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 64 * wg + 8 * j) =
            pack_bf16(dka[4 * j + 2 * hr] * scale,
                      dka[4 * j + 2 * hr + 1] * scale);
        if (j / 4 == wg)
          *reinterpret_cast<uint32_t*>(dkr + 2 * kBox + 8 * j) =
              pack_bf16(dk2[4 * j + 2 * hr] * scale,
                        dk2[4 * j + 2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j) =
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

// the bf16 design of a pair: flash_bwd_wgmma_wide past two q.k boxes
template <int DQK, int DV>
constexpr bool kWide = DQK > 2 * kBox;
template <int DQK, int DV>
using BwdTraits = std::conditional_t<kWide<DQK, DV>, WideTraits<DQK, DV>,
                                     WgTraits<DQK, DV>>;
template <int DQK, int DV>
constexpr auto bwd_kernel() {
  if constexpr (kWide<DQK, DV>)
    return flash_bwd_wgmma_wide<DQK, DV>;
  else
    return flash_bwd_wgmma<DQK, DV>;
}

template <int DQK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dO, const float* lse,
                         const float* delta, float* dq_acc, void* dk,
                         void* dv, int B, int S, int H, int KH, int causal,
                         float scale, Strides qs, Strides ks, Strides vs,
                         Strides dos, cudaStream_t stream) {
  using T = BwdTraits<DQK, DV>;
  constexpr auto kernel = bwd_kernel<DQK, DV>();
  static bool ready[64] = {false};
  cudaError_t err = allow_smem(kernel, T::kSmemBytes, ready);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // dq's accumulator: contiguous (B, S, H, DQK) f32, boxes of 64 rows x 32
  const Strides acc{(long long)S * H * DQK, (long long)H * DQK, DQK};
  CUtensorMap qm, km, vm, dom, dqm;
  if (!make_map(&qm, encode, q, B, S, H, DQK, T::kBQ, qs) ||
      !make_map(&km, encode, k, B, S, KH, DQK, T::kBK, ks) ||
      !make_map(&vm, encode, v, B, S, KH, DV, T::kBK, vs) ||
      !make_map(&dom, encode, dO, B, S, H, DV, T::kBQ, dos) ||
      !make_map(&dqm, encode, dq_acc, B, S, H, DQK, T::kBQ, acc, true))
    return cudaErrorInvalidValue;
  const int tiles = (S + T::kBK - 1) / T::kBK;
  const dim3 grid = kWide<DQK, DV> ? dim3(tiles, B * KH) : dim3(B * KH, tiles);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, dom, dqm, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KH, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
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
    err = allow_smem(flash_bwd<DQK, DV>, smem_bytes<DQK, DV>(), ready);
    if (err != cudaSuccess) return err;
  }
  const long long rows = (long long)B * S * H;
  bwd_prep<T><<<(unsigned)((rows + kPrepWarps - 1) / kPrepWarps),
                32 * kPrepWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, dq_acc, B,
      S, H, DQK, DV, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kBf16) {
    err = launch_wgmma<DQK, DV>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B,
                                S, H, KH, causal, scale, qs, ks, vs, dos,
                                stream);
    if (err != cudaSuccess) return err;
    const long long n = rows * DQK;
    const long long blocks = (n + 255) / 256;
    cast_dq<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
              stream>>>(dq_acc, static_cast<bf16*>(dq), n);
  } else {
    const dim3 grid(B * KH, (S + kBK - 1) / kBK);
    flash_bwd<DQK, DV><<<grid, kThreads, smem_bytes<DQK, DV>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), S,
        H, KH, qs, ks, vs, dos, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements; q (B, S, H,
// Dqk), k (B, S, KH, Dqk), v (B, S, KH, Dv), o and dO (B, S, H, Dv) with
// their last dimension contiguous, and for bfloat16 their rows 16-byte
// aligned (base pointer and strides; the wrapper checks); lse and delta
// contiguous f32 (B, H, S); dq, dk, dv contiguous outputs of q's, k's and
// v's shapes; dq_acc a contiguous f32 (B, S, H, Dqk) scratch, or dq itself
// for float32. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a (Dqk, Dv) pair or type the library was not
// built for, or strides TMA refuses; cudaErrorNotSupported where
// cuTensorMapEncodeTiled cannot be found.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv,
    void* dq_acc, void* delta, int B, int S, int H, int KH, int Dqk, int Dv,
    int dtype,
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
#define FA_LAUNCH(DQK, DV)                                                 \
  if (dtype == 0 && Dqk == DQK && Dv == DV)                                \
    return launch<float, DQK, DV>(q, k, v, o, l, dO, dq, dk, dv, acc, dl,  \
                                  B, S, H, KH, causal, scale, qs, ks, vs,  \
                                  os, dos, st);                            \
  if (dtype == 1 && Dqk == DQK && Dv == DV)                                \
    return launch<bf16, DQK, DV>(q, k, v, o, l, dO, dq, dk, dv, acc, dl, B, \
                                 S, H, KH, causal, scale, qs, ks, vs, os,  \
                                 dos, st);
  FA_PAIRS(FA_LAUNCH)
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
