// Causal / full softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, flash_attention): out = softmax(q k^T * D^-0.5) v with
// the causal mask at -1e30, K tiles above the diagonal skipped, f32 running
// max / denominator / accumulator, the denominator clamped at 1e-30 and the
// output in the input type. Inputs are bf16 or f32.
//
// Layout: q is read in the model's (B, S, H, D) layout and k, v in
// (B, S, KH, D), through their batch / sequence / head strides (the last
// dimension contiguous), so no transpose is made; query head h reads KV
// head h / (H / KH) (grouped-query attention). The output is a contiguous
// (B, S, H, D) tensor.
//
// Bound on an H100 SXM: at B*H = 64, S = 4096, D = 64, causal, the function
// does 2 * 2 * (S^2 / 2) * D * B*H = 137 GFLOP, 0.14 ms at 989 TFLOP/s of
// bf16 tensor-core work, and moves 134 MB of q, k, v, o in bf16, 0.04 ms at
// 3.35 TB/s: it is bound by operations, so bf16 goes to the tensor cores.
//
// Both designs: one CTA per (query tile, batch*head). The TPU's
// sequential K grid axis becomes a loop inside the CTA over K/V tiles (64
// rows in f32, 128 in bf16), up to the diagonal when causal, with the
// running max, denominator and output accumulator in f32 registers. CTAs
// run the longest (last) query tiles first, so the causal triangle's
// uneven work drains evenly. The ragged edge (S not a multiple of the
// tile) is masked in the kernel: missing K rows score -1e30 and missing
// query rows are not written.
//
// For training, both designs also write each query row's log-sum-exp of
// its scaled, masked scores, in f32 and in the natural base (lse = m +
// ln l), to a (B, H, S) tensor when the caller passes one (the backward
// kernel, flash_attention_bwd.cu, recomputes the probabilities from it);
// the prefill and serve paths pass a null pointer and write none. The
// tensor-core design keeps its running max in base 2 (scores times
// scale * log2 e), so it converts once per row at the end: lse = (m2 +
// log2 l) * ln 2.
//
// flash_fwd_wgmma (bf16 inputs, D = 64 or 128; base pointers and strides
// 16-byte aligned, which the wrapper checks): a warp-specialised Hopper
// kernel. One CTA takes BQ query rows of one (batch, head): 64 rows for
// each consumer warpgroup, 3 of them at D = 64 (BQ = 192, 512 threads)
// and 2 at D = 128 (BQ = 128, 384 threads), where a thread's registers
// allow no third:
//   - warpgroup 0 gives up its registers (setmaxnreg 24); its first thread
//     issues the copies, by TMA through CUtensorMaps that the launch
//     function encodes per call over the strided 4-d tensors (q: {D, H, S,
//     B}; k, v: {D, KH, S, B}; byte strides from the tensors; boxes of 64
//     columns x BQ (q) or 128 (k, v) rows, 128-byte swizzled, so D = 128
//     is two boxes). Q is loaded once; 128-row K and V tiles go through a
//     ring of 3 (D = 64) or 2 (D = 128) stages, each with full barriers
//     (K and V apart, so Q K^T starts before V lands) and an empty
//     barrier that every consumer warp releases. Rows past S arrive as
//     zeros.
//   - the consumer warpgroups (setmaxnreg 160 or 240) own 64 query rows
//     each. S = Q K^T is wgmma m64n128k16 with both operands in shared
//     memory (K-major descriptors); the online softmax runs on the f32
//     accumulator fragments in base 2 (scale * log2 e folded into one
//     FMA, ex2.approx on the special-function unit), masking only the
//     tiles that reach past the CTA's first row or past S; P is rounded
//     to bf16 in registers and becomes the A operand of O += P V (wgmma
//     m64nDk16, V read as an MN-major B operand through its descriptor),
//     as the reference model rounds its weights before that product.
//     While one warpgroup runs its softmax the others' products keep the
//     tensor cores busy.
// Grid: (B*H, query tiles), the longest (last) query tiles launched first.

// flash_fwd (f32 inputs): scalar f32 FMAs, 256 threads. Q, the K/V tile
// and the probability tile sit in shared memory as f32 (rows padded to D+1
// floats). Each thread owns a 4x4 block of the 64x64 score tile (rows
// rg + 16 i, columns cg + 16 j) and the matching 4 x D/16 block of the
// output accumulator; a row's max and sum are reduced over the 16 lanes
// that share it. At most 67 TFLOP/s of f32, about half of that reachable
// with one shared-memory load per two FMAs.

#include <cuda.h>  // CUtensorMap (encoded at run time, see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // K/V rows per tile
constexpr int kLP = kBK + 1;        // padded row of the probability tile
constexpr float kNegInf = -1e30f;   // the reference's mask value

struct Strides {
  long long b, s, h;
};

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * kLP) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int S, int H, int G,
          Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int CJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;             // [kBQ][LD]
  float* sk = sq + kBQ * LD;    // [kBK][LD]
  float* sv = sk + kBK * LD;    // [kBK][LD]
  float* sp = sv + kBK * LD;    // [kBQ][kLP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    sq[r * LD + d] = t < S ? qb[t * qs.s + d] : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kend + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers of sk, sv, sp are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      const bool ok = t < S;
      sk[r * LD + d] = ok ? kb[t * ks.s + d] : 0.f;
      sv[r * LD + d] = ok ? vb[t * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        sp[(rg + 16 * i) * kLP + cg + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(rg + 16 * i) * kLP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = sv[c * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // the output is contiguous (B, S, H, HD)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) orow[cg + 16 * j] = acc[i][j] / denom;
    // m and l are the row's own in all 16 lanes that share it
    if (lse != nullptr && cg == 0)
      lse[((long long)b * H + h) * S + row] = m[i] + logf(denom);
  }
}

// ------------------------------------- tensor-core bf16 path (TMA + wgmma)
constexpr int kWgBK = 128;          // K/V rows per tile
constexpr int kBox = 64;            // bf16 columns of one 128-byte TMA box
constexpr int kBoxBytes = kWgBK * kBox * 2;  // one 128-row box: 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct WgTraits {
  static constexpr int kWGs = HD == 64 ? 3 : 2;        // consumer warpgroups
  static constexpr int kBQ = 64 * kWGs;                // query rows a CTA
  static constexpr int kThreads = 128 * (kWGs + 1);    // + the producer's
  // registers a consumer thread gets once the producer drops to 24
  static constexpr int kConsumerRegs =
      ((65536 - 24 * 128) / (128 * kWGs)) / 8 * 8 > 240
          ? 240
          : ((65536 - 24 * 128) / (128 * kWGs)) / 8 * 8;
  static constexpr int kBlocks = HD / kBox;            // boxes a row
  static constexpr int kStages = HD == 64 ? 3 : 2;     // K/V ring depth
  static constexpr int kQBoxBytes = kBQ * kBox * 2;
  static constexpr int kTileBytes = kBlocks * kBoxBytes;  // a K or V tile
  // Q, then K and V stages, then the mbarriers; +1 KB to align to 1 KB
  static constexpr int kBarOffset =
      kBlocks * kQBoxBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmemBytes = kBarOffset + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of more than
// about 2^32 cycles (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One 4-d TMA box {64 columns, 1 head, 128 rows, 1 batch} into `dst`
// (128-byte swizzled); rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across the async product
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (128 x 16, smem,
// K-major)^T; both 128-byte swizzled
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major, 128-byte swizzled)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major, 128-byte swizzled)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// 2^x on the special-function unit alone (ex2.approx.ftz: results below
// 2^-126 flush to zero, which a softmax weight relative to 1 may do)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// One CTA: BQ query rows of one (batch, head). Warp 0 of warpgroup 0
// issues the TMA copies; each further warpgroup owns 64 query rows.
template <int HD>
__global__ void __launch_bounds__(WgTraits<HD>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int H, int G, float scale_log2, int causal) {
  using T = WgTraits<HD>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + T::kBlocks * T::kQBoxBytes;
  const uint32_t sv = sk + kStages * T::kTileBytes;
  const uint32_t bars = base + T::kBarOffset;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBQ;  // longest first
  const int kend = causal ? min(S, q0 + T::kBQ) : S;
  const int n_tiles = (kend + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * T::kWGs);  // each consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, T::kBlocks * T::kQBoxBytes);
      for (int c = 0; c < T::kBlocks; ++c)
        tma_load(sq + c * T::kQBoxBytes, &qmap, full_q, c * kBox, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(st), T::kTileBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load(sk + st * T::kTileBytes + c * kBoxBytes, &kmap,
                   full_k(st), c * kBox, kh, kt * kWgBK, b);
        mbar_expect_tx(full_v(st), T::kTileBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load(sv + st * T::kTileBytes + c * kBoxBytes, &vmap,
                   full_v(st), c * kBox, kh, kt * kWgBK, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::kConsumerRegs)
                 : "memory");
    const int wg = threadIdx.x / 128 - 1;        // rows 64 wg .. 64 wg + 63
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;        // fragment row, col pair
    const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
    // Q: rows 64 wg .. of each 64-column box, K-major, 8-row groups 1 KB
    const uint32_t qa = sq + wg * 64 * 128;

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(full_q, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const uint32_t ph = (kt / kStages) & 1;
      const int k0 = kt * kWgBK;
      const uint32_t ka = sk + st * T::kTileBytes;
      const uint32_t va = sv + st * T::kTileBytes;
      mbar_wait(full_k(st), ph);

      // S = Q K^T: 64 x 128 keys, HD / 16 k-steps of 32 bytes in a box
      float s[64];
      pin(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        wgmma_ss_n128(s, wg_desc(qa + (kk / 4) * T::kQBoxBytes + col, 16, 1024),
                      wg_desc(ka + (kk / 4) * kBoxBytes + col, 16, 1024),
                      kk > 0);
      }
      wg_commit();
      wg_wait0();
      pin(s);

      // mask the diagonal tile and the ragged last tile only
      // (tiles reaching past the CTA's first row, or past S)
      if ((causal && k0 + kWgBK > q0 + 1) || k0 + kWgBK > S) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= S || (causal && col > row)) s[4 * j + e] = kNegInf;
          }
      }

      // online softmax in base 2: p = 2^(s * scale log2 e - m)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * corr0 + sum0;  // this thread's columns; summed at the end
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        oacc[4 * j] *= corr0;
        oacc[4 * j + 1] *= corr0;
        oacc[4 * j + 2] *= corr1;
        oacc[4 * j + 3] *= corr1;
      }

      // P in bf16 as the A fragments of O += P V (keys 16 kk .. 16 kk + 15)
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(full_v(st), ph);
      pin(oacc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pin(pa[kk]);
      wg_fence();
      // V: MN-major, 16 keys = two 8-row groups (1 KB apart) per k-step,
      // the 64-column boxes 16 KB apart
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<HD>(oacc, pa[kk], wg_desc(va + kk * 16 * 128, kBoxBytes,
                                           1024));
      wg_commit();
      wg_wait0();
      pin(oacc);
      if (lane == 0) mbar_arrive(empty(st));
    }

    // the output is contiguous (B, S, H, HD)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + ((long long)b * S * H + h) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * H * HD + 8 * j) =
            pack_bf16(oacc[4 * j] / d0, oacc[4 * j + 1] / d0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * H * HD + 8 * j) =
            pack_bf16(oacc[4 * j + 2] / d1, oacc[4 * j + 3] / d1);
    }
    // the running max m0, m1 is in base 2, the same in the 4 lanes of a
    // row; the log-sum-exp is stored in the natural base
    if (lse != nullptr && c == 0) {
      float* lrow = lse + ((long long)b * H + h) * S;
      if (row0 < S) lrow[row0] = (m0 + log2f(d0)) * kLn2;
      if (row1 < S) lrow[row1] = (m1 + log2f(d1)) * kLn2;
    }
  }
}

// cuTensorMapEncodeTiled, found at run time through the CUDA runtime, so
// the library links nothing else.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, S, heads, HD) bf16 tensor with element strides st:
// dimensions {HD, heads, S, B}, boxes of {64, 1, 128, 1}.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int heads, int HD, int rows, Strides st) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int H, int KH,
                         Strides qs,
                         Strides ks, Strides vs, float scale, int causal,
                         cudaStream_t stream) {
  static bool ready[64] = {false};  // shared-memory limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgTraits<HD>::kSmemBytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  using T = WgTraits<HD>;
  if (!make_map(&qm, encode, q, B, S, H, HD, T::kBQ, qs) ||
      !make_map(&km, encode, k, B, S, KH, HD, kWgBK, ks) ||
      !make_map(&vm, encode, v, B, S, KH, HD, kWgBK, vs))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + T::kBQ - 1) / T::kBQ);
  flash_fwd_wgmma<HD><<<grid, T::kThreads, T::kSmemBytes,
                        stream>>>(qm, km, vm,
                                  static_cast<__nv_bfloat16*>(o), lse, S, H,
                                  H / KH, scale * kLog2e, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------- scalar path
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KH, Strides qs,
                   Strides ks,
                   Strides vs, float scale, int causal, cudaStream_t stream) {
  static bool ready[64] = {false};  // shared-memory limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd<HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, H / KH,
      qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32 (scalar FMAs), 1 bfloat16 (tensor cores; the base
// pointers and every stride must be 16-byte aligned for TMA: the wrapper
// checks). Strides are in elements. lse: null, or a contiguous f32
// (B, H, S) tensor that receives each query row's natural-log
// log-sum-exp. Returns a CUDA error code (0 on
// success); cudaErrorInvalidValue for a head size or type the library was
// not built for, or strides TMA refuses; cudaErrorNotSupported where
// cuTensorMapEncodeTiled cannot be found.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse_, int B, int S, int H, int KH,
                           int D,
                           int dtype, int causal, float scale,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_);
  if (dtype == 0 && D == 64)
    return launch<64>(q, k, v, o, lse, B, S, H, KH, qs, ks, vs, scale,
                      causal, st);
  if (dtype == 0 && D == 128)
    return launch<128>(q, k, v, o, lse, B, S, H, KH, qs, ks, vs, scale,
                       causal, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, o, lse, B, S, H, KH, qs, ks, vs, scale,
                            causal, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, o, lse, B, S, H, KH, qs, ks, vs,
                             scale, causal, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
