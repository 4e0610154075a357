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
// bf16 are 537 MB, 0.16 ms at 3.35 TB/s: bound by operations.
//
// Three launches:
//   1. bwd_prep: one warp a (batch, row, head): D = rowsum(dO o O) into an
//      f32 (B, H, S) buffer, and the row of dq's f32 accumulator zeroed.
//   2. the main kernel: one CTA per (KV head of a batch, 64-key tile), the
//      tiles with the most query tiles under the causal mask (the first
//      keys) launched first. K and V stay in shared memory; dK and dV
//      accumulate in f32 registers while the CTA loops over the G query
//      heads of its KV head and, for each, over the 64-row query tiles
//      from the diagonal on (all of them without the mask): so the GQA sum
//      needs no atomics. A tile pair recomputes S^T and dP^T (keys x
//      queries), turns them into P^T and dS^T, adds P^T dO and dS^T Q into
//      dV and dK, and adds scale dS K into dq's f32 accumulator with
//      atomics (red.add). Keys and queries past S load as zeros and get
//      P = 0, so they add exactly 0; their dK, dV rows are not written.
//   3. cast_dq (bf16 only): dq's f32 accumulator to bf16. An f32 dq is
//      accumulated in place.
//
// flash_bwd_mma (bf16): the five products on the tensor cores, mma.sync
// m16n8k16 (bf16 operands, f32 sums), 4 warps, each owning 16 of the
// tile's keys. K, V, Q, dO and dS sit in shared memory as bf16 rows padded
// by 16 bytes (fragment loads and ldmatrix rows then fall on distinct
// banks); the operands that the products need transposed (dO and Q for
// dV and dK, K for dQ) are read with ldmatrix.trans, so no transposed
// copy is kept. P^T and dS^T go from the f32 accumulator fragments of S^T
// and dP^T straight into the A fragments of P^T dO and dS^T Q, rounded to
// bf16 as the forward rounds P before P V; dS also goes to shared memory
// (queries x keys), from which each warp takes 16 queries of scale dS K.
// The softmax runs in base 2 (the log-sum-exp times log2 e, read once a
// row). wgmma, TMA and a dQ pass without atomics are later designs.
//
// flash_bwd (f32): scalar f32 FMAs, 256 threads: each thread a 4 x 4 block
// of S^T and dP^T (one pass over d for both) and a 4 x D/16 block of dK,
// dV and dQ; P^T and dS^T through shared memory. At most 67 TFLOP/s of
// f32, about a third of it reachable with one shared-memory load per two
// FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows a tile
constexpr int kBK = 64;           // key rows a CTA
constexpr int kLP = kBQ + 1;      // padded row of the P^T and dS^T tiles
constexpr int kPrepWarps = 8;

struct Strides {
  long long b, s, h;
};

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
constexpr int kMmaWarps = 4;                 // 16 of the tile's keys each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct MmaTraits {
  static constexpr int LR = HD + 8;           // padded row of a [64][HD] tile
  static constexpr int LS = kBK + 8;          // padded row of dS [64][64]
  static constexpr int TILE = kBQ * LR;       // K, V, Q, dO
  static constexpr int BYTES = (4 * TILE + kBQ * LS) * 2 + 2 * kBQ * 4;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// four 8 x 8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
// c += a b: m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the A fragment of the 16 x 16 block at p (rows ld elements apart)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int g, int c) {
  a[0] = ld32(p + g * ld + 2 * c);
  a[1] = ld32(p + (g + 8) * ld + 2 * c);
  a[2] = ld32(p + g * ld + 2 * c + 8);
  a[3] = ld32(p + (g + 8) * ld + 2 * c + 8);
}

// 64 rows from row r0 of a (rows ss elements apart, 16-byte aligned) into
// dst [64][HD + 8]; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_tile(const bf16* src, long long ss,
                                          int r0, int S, bf16* dst,
                                          int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int i = tid; i < kBQ * CH; i += kMmaThreads) {
    const int r = i / CH, ch = i % CH, t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < S) val = *reinterpret_cast<const uint4*>(src + t * ss + 8 * ch);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + 8 * ch) = val;
  }
}

// grid (B * KH, key tiles); blockIdx.y = 0 holds the first keys
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq_acc, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int S, int H, int KH, Strides qs,
              Strides ks, Strides vs, Strides dos, float scale, int causal) {
  using L = MmaTraits<HD>;
  constexpr int LR = L::LR, LS = L::LS;
  constexpr int NT = HD / 8;    // n-tiles of 8 d columns
  constexpr int KD = HD / 16;   // k-steps over d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64 keys][LR]
  bf16* sV = sK + L::TILE;                       // [64 keys][LR]
  bf16* sQ = sV + L::TILE;                       // [64 queries][LR]
  bf16* sdO = sQ + L::TILE;                      // [64 queries][LR]
  bf16* sdS = sdO + L::TILE;                     // [64 queries][LS]: dS
  float* slse = reinterpret_cast<float*>(sdS + kBQ * LS);  // times log2 e
  float* sdelta = slse + kBQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;  // fragment row, column pair
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kBK;
  const int key0 = 16 * warp;             // the warp's keys in the tile
  const float scale_log2 = scale * kLog2e;

  load_tile<HD>(k + b * ks.b + kh * ks.h, ks.s, k0, S, sK, tid);
  load_tile<HD>(v + b * vs.b + kh * vs.h, vs.s, k0, S, sV, tid);

  // dK, dV of the warp's 16 keys: rows g, g + 8, columns 8 nt + 2 c (+1)
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  const int qt0 = causal ? k0 / kBQ : 0;  // query tiles above it see no key
  const int n_qt = (S + kBQ - 1) / kBQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dO + b * dos.b + h * dos.h;
    const float* lseb = lse + ((long long)b * H + h) * S;
    const float* deltab = delta + ((long long)b * H + h) * S;
    float* dqb = dq_acc + ((long long)b * S * H + h) * HD;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the last tile's readers are done (and K, V set)
      load_tile<HD>(qb, qs.s, q0, S, sQ, tid);
      load_tile<HD>(dob, dos.s, q0, S, sdO, tid);
      if (tid < kBQ) {
        const int t = q0 + tid;
        slse[tid] = t < S ? lseb[t] * kLog2e : 0.f;
        sdelta[tid] = t < S ? deltab[t] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries,
      // n-tiles of 8 queries
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4];
        frag_a(ak, sK + key0 * LR + 16 * kd, LR, g, c);
        frag_a(av, sV + key0 * LR + 16 * kd, LR, g, c);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* bq = sQ + (8 * nt + g) * LR + 16 * kd + 2 * c;
          const bf16* bd = sdO + (8 * nt + g) * LR + 16 * kd + 2 * c;
          mma(st[nt], ak, ld32(bq), ld32(bq + 8));
          mma(dpt[nt], av, ld32(bd), ld32(bd + 8));
        }
      }

      // P^T and dS^T; masked pairs and rows or keys past S give exactly 0.
      // dS also to shared memory, queries x keys, for dQ.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = key0 + g + (e >= 2 ? 8 : 0);  // key in the tile
          const int ql = 8 * nt + 2 * c + (e & 1);     // query in the tile
          const int key = k0 + kl, row = q0 + ql;
          float p = 0.f;
          if (key < S && row < S && (!causal || key <= row))
            p = exp2f(fmaf(st[nt][e], scale_log2, -slse[ql]));
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sdelta[ql]);
          sdS[ql * LS + kl] = __float2bfloat16_rn(dpt[nt][e]);
        }
      }
      // the accumulator fragments (n-tiles of 8 queries) as A fragments
      // (k-steps of 16 queries)
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        pa[kq][0] = pack(st[2 * kq][0], st[2 * kq][1]);
        pa[kq][1] = pack(st[2 * kq][2], st[2 * kq][3]);
        pa[kq][2] = pack(st[2 * kq + 1][0], st[2 * kq + 1][1]);
        pa[kq][3] = pack(st[2 * kq + 1][2], st[2 * kq + 1][3]);
        sa[kq][0] = pack(dpt[2 * kq][0], dpt[2 * kq][1]);
        sa[kq][1] = pack(dpt[2 * kq][2], dpt[2 * kq][3]);
        sa[kq][2] = pack(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]);
        sa[kq][3] = pack(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3]);
      }

      // dV += P^T dO, dK += dS^T Q (the scale at the end): B operands dO
      // and Q (queries x d, row-major) read transposed, two n-tiles a load
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int row = 16 * kq + (lane & 15);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          const int col = 8 * (nt + (lane >> 4));
          uint32_t bd[4], bq[4];
          ldsm4t(bd, sdO + row * LR + col);
          ldsm4t(bq, sQ + row * LR + col);
          mma(dva[nt], pa[kq], bd[0], bd[1]);
          mma(dva[nt + 1], pa[kq], bd[2], bd[3]);
          mma(dka[nt], sa[kq], bq[0], bq[1]);
          mma(dka[nt + 1], sa[kq], bq[2], bq[3]);
        }
      }
      __syncthreads();  // dS of all four warps in shared memory

      // dQ += scale dS K: the warp's 16 queries x HD, over the 64 keys, in
      // two halves of the columns; K (keys x d, row-major) read transposed
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float dqa[NT / 2][4];
#pragma unroll
        for (int nt = 0; nt < NT / 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          frag_a(a, sdS + key0 * LS + 16 * kk, LS, g, c);
          const int row = 16 * kk + (lane & 15);
#pragma unroll
          for (int nt = 0; nt < NT / 2; nt += 2) {
            uint32_t bk[4];
            ldsm4t(bk, sK + row * LR + half * (HD / 2) +
                           8 * (nt + (lane >> 4)));
            mma(dqa[nt], a, bk[0], bk[1]);
            mma(dqa[nt + 1], a, bk[2], bk[3]);
          }
        }
        const int r0 = q0 + key0 + g, r1 = r0 + 8;  // warp's query rows
#pragma unroll
        for (int nt = 0; nt < NT / 2; ++nt) {
          const int d = half * (HD / 2) + 8 * nt + 2 * c;
          if (r0 < S) {
            float* p = dqb + (long long)r0 * H * HD + d;
            atomicAdd(p, dqa[nt][0] * scale);
            atomicAdd(p + 1, dqa[nt][1] * scale);
          }
          if (r1 < S) {
            float* p = dqb + (long long)r1 * H * HD + d;
            atomicAdd(p, dqa[nt][2] * scale);
            atomicAdd(p + 1, dqa[nt][3] * scale);
          }
        }
      }
    }
  }

  // dk, dv: contiguous (B, S, KH, HD); rows g and g + 8 of the warp's keys
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + key0 + g + 8 * hr;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * KH + kh) * HD + 2 * c;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * nt) =
          pack(dka[nt][2 * hr] * scale, dka[nt][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * nt) =
          pack(dva[nt][2 * hr], dva[nt][2 * hr + 1]);
    }
  }
}

__global__ void cast_dq(const float* __restrict__ acc,
                        __nv_bfloat16* __restrict__ dq, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dq[i] = __float2bfloat16_rn(acc[i]);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dO, void* dq,
                   void* dk, void* dv, float* dq_acc, float* delta, int B,
                   int S, int H, int KH, int causal, float scale, Strides qs,
                   Strides ks, Strides vs, Strides os, Strides dos,
                   cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kSmem = kMma ? MmaTraits<HD>::BYTES : smem_bytes<HD>();
  static bool ready[64] = {false};  // shared-memory limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    if constexpr (kMma)
      err = cudaFuncSetAttribute(flash_bwd_mma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    else
      err = cudaFuncSetAttribute(flash_bwd<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const long long rows = (long long)B * S * H;
  bwd_prep<T><<<(unsigned)((rows + kPrepWarps - 1) / kPrepWarps),
                32 * kPrepWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, dq_acc, B,
      S, H, HD, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KH, (S + kBK - 1) / kBK);
  if constexpr (kMma)
    flash_bwd_mma<HD><<<grid, kMmaThreads, kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse,
        delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
        KH, qs, ks, vs, dos, scale, causal);
  else
    flash_bwd<HD><<<grid, kThreads, kSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), S,
        H, KH, qs, ks, vs, dos, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kMma) {
    const long long n = rows * HD;
    const long long blocks = (n + 255) / 256;
    cast_dq<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
              stream>>>(dq_acc, static_cast<bf16*>(dq), n);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements; q, o, dO
// (B, S, H, D) and k, v (B, S, KH, D) with their last dimension
// contiguous, and for bfloat16 their rows 16-byte aligned (base pointer
// and strides; the wrapper checks); lse and delta contiguous f32
// (B, H, S); dq, dk, dv contiguous outputs; dq_acc a contiguous f32
// (B, S, H, D) scratch, or dq itself for float32. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a head size or type the library was not built
// for.
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
