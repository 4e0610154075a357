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
// Both designs: one CTA per (query tile of 64 rows, batch*head). The TPU's
// sequential K grid axis becomes a loop inside the CTA over K/V tiles of 64
// rows, up to the diagonal when causal, with the running max, denominator
// and output accumulator in f32 registers. CTAs run the longest (last)
// query tiles first, so the causal triangle's uneven work drains evenly.
// The ragged edge (S not a multiple of 64) is masked in the kernel: missing
// K rows score -1e30 and missing query rows are not written.
//
// flash_fwd_mma (bf16 inputs, D = 64 or 128; rows 16-byte aligned, which
// the wrapper checks): 4 warps, each owning 16 query rows. Q, K and V
// tiles sit in shared memory as bf16 (rows padded by 16 bytes, so ldmatrix
// hits distinct banks). S = Q K^T and O += P V are mma.sync m16n8k16 bf16
// products with f32 accumulators; the softmax runs on the accumulator
// fragments (a row's max and sum reduced over the 4 lanes of a quad), and
// P is rounded to bf16 in registers to become the A operand of P V, as the
// reference model rounds its weights before that product. Copies are not
// pipelined yet (TMA / cp.async and wgmma are the next steps for speed).
//
// flash_fwd (f32 inputs): scalar f32 FMAs, 256 threads. Q, the K/V tile
// and the probability tile sit in shared memory as f32 (rows padded to D+1
// floats). Each thread owns a 4x4 block of the 64x64 score tile (rows
// rg + 16 i, columns cg + 16 j) and the matching 4 x D/16 block of the
// output accumulator; a row's max and sum are reduced over the 16 lanes
// that share it. At most 67 TFLOP/s of f32, about half of that reachable
// with one shared-memory load per two FMAs.

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
          const float* __restrict__ v, float* __restrict__ o, int S, int H,
          int G,
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
  }
}

// ---------------------------------------------------- tensor-core bf16 path
constexpr int kMmaThreads = 128;

template <int HD>
constexpr int mma_smem_bytes() {
  return 3 * kBQ * (HD + 8) * 2;  // Q, K, V tiles of bf16, padded rows
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows t0 .. t0+63 of a (S, HD) bf16 matrix with row stride rs (elements)
// into shared rows of LD elements, 16 bytes a load; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int t0, int S) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int i = threadIdx.x; i < kBQ * CH; i += kMmaThreads) {
    const int r = i / CH, ch = i % CH, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < S) val = *reinterpret_cast<const uint4*>(src + t * rs + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int H, int G, Strides qs,
              Strides ks, Strides vs, float scale, int causal) {
  constexpr int LD = HD + 8;   // padded shared row (bf16 elements)
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = HD / 8;   // 8-column tiles of the output
  static_assert(kBK == 64, "P V below walks 4 k-steps of 16 keys");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBQ * LD;
  __nv_bfloat16* sv = sk + kBK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;  // accumulator row and column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  load_tile<HD>(sq, q + b * qs.b + h * qs.h, qs.s, q0, S);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kend = causal ? min(S, q0 + kBQ) : S;
  const int n_tiles = (kend + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the last K/V tile
    load_tile<HD>(sk, kb, ks.s, k0, S);
    load_tile<HD>(sv, vb, vs.s, k0, S);
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys: 8 tiles of 8 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // key tiles 2 jp and 2 jp + 1
        uint32_t bf[4];
        ldsm_x4(bf, sk + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * c + e;
        float x0 = s[j][e] * scale, x1 = s[j][2 + e] * scale;
        if (col >= S || (causal && col > row0)) x0 = kNegInf;
        if (col >= S || (causal && col > row1)) x1 = kNegInf;
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mn0);
        s[j][2 + e] = expf(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // keys 16 kk .. 16 kk + 15
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // output tiles 2 np, 2 np + 1
        uint32_t bf[4];
        ldsm_x4_trans(bf, sv + (16 * kk + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * LD +
                              16 * np + ((lane >> 4) << 3));
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // the output is contiguous (B, S, H, HD)
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * HD + 2 * c;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * H * HD + 8 * n) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * H * HD + 8 * n) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KH, Strides qs, Strides ks,
                       Strides vs, float scale, int causal,
                       cudaStream_t stream) {
  static bool ready[64] = {false};  // shared-memory limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_mma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mma_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_mma<HD><<<grid, kMmaThreads, mma_smem_bytes<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, H / KH, qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------- scalar path
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, Strides qs, Strides ks,
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
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / KH, qs,
      ks, vs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32 (scalar FMAs), 1 bfloat16 (tensor cores; the base
// pointers and every stride must allow 16-byte loads: the wrapper checks).
// Strides are in elements. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a head size or type the library was not built
// for.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KH, int D,
                           int dtype, int causal, float scale,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<64>(q, k, v, o, B, S, H, KH, qs, ks, vs, scale, causal, st);
  if (dtype == 0 && D == 128)
    return launch<128>(q, k, v, o, B, S, H, KH, qs, ks, vs, scale, causal,
                       st);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, o, B, S, H, KH, qs, ks, vs, scale, causal,
                          st);
  if (dtype == 1 && D == 128)
    return launch_mma<128>(q, k, v, o, B, S, H, KH, qs, ks, vs, scale, causal,
                           st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
