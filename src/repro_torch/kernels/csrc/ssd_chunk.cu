// Mamba2 / SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py
// (_ssd_kernel, ssd_chunk): for each (batch, head), with one B and C shared
// by all heads and no D skip,
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . h_t
// computed chunk by chunk (Q = 64 steps): within a chunk the quadratic form
//     y = (C B^T  (.) exp(lcum_t - lcum_s) [s <= t]  (.) dt_s) x
//       + exp(lcum_t) C h_prev
// with lcum the inclusive cumulative sum of dt A, then the state update
//     h = exp(lcum_end) h + sum_s B_s (exp(lcum_end - lcum_s) dt_s) x_s.
// x and y are (B, S, nh, hd) in bf16 or f32, B and C (B, S, ds) in x's type,
// dt (B, S, nh) and A (nh,) in f32; all sums are f32 and y is rounded once
// to x's type. Rows past S load as zeros (dt = 0: no decay and no input)
// and are not stored. x, B, C and dt are read through their batch,
// sequence (and head) strides, so the model's slices of one packed
// projection go in without a copy.
//
// Bound on an H100 SXM: at B = 2, S = 4096, nh = 64, hd = 64, ds = 64 in
// bf16 the function reads x (67 MB), B, C and dt (about 4 MB) and writes y
// (67 MB): about 0.041 ms at 3.35 TB/s. Its chunked arithmetic is four
// 64 x 64 x 64 products per chunk (C B^T, att x, C h, B^T x), 2.1 MFLOP,
// so 17.2 GFLOP per call over 64 chunks and 128 (batch, head) pairs:
// 0.017 ms of bf16 tensor-core work. It is bound by bytes.
//
// ssd_fwd_mma (bf16): the TPU's chunk loop (a fori_loop over VMEM blocks)
// becomes a loop inside the CTA, and what would keep it from its bound
// is met item by item:
//   - More CTAs. y[:, j] depends only on x[:, j] and the state's column j,
//     so hd is cut into kSlices = 2 column slices of HS = hd / 2, one CTA
//     each: grid (2, nh, B). At the prefill that is 256 CTAs of 8 warps,
//     two an SM (the register budget is set for two); 1 slice leaves half
//     the SMs' warp slots empty and 4 redo the shared work (C B^T, the
//     loads of B and C) twice as often, and both were slower
//     (chip_probes.py). Each CTA walks the chunks in order with its
//     (ds x HS) f32 state in registers, so each byte of x is read once; B
//     and C, shared by every head, are read again per head and slice
//     from L2.
//   - Tensor cores. The four products run on mma.sync m16n8k16 (bf16 in,
//     f32 sums), their operands fed by ldmatrix from shared tiles whose
//     rows are padded by 16 bytes (conflict-free). An operand derived in
//     f32 is never rounded to bf16 once: att, the carried state h (in
//     C h_prev) and w (.) x (in the state update) are each split into a
//     bf16 high part and a bf16 low part, v = hi + lo to about 16 bits,
//     and go through two products (att's low part alone moves the tight
//     check's reading from 1.66e-3 to 2.33e-3; chip_probes.py).
//     That is 7 products a chunk in place of 4, still under the bytes'
//     bound at the tensor cores' rate.
//   - Two kinds of warps, whose work within a chunk is independent:
//     4 row warps each own 16 rows of the chunk: y = exp(lcum_t) C h_prev
//     (h_prev's halves from shared memory), then, a 16-step block of s at
//     a time up to the diagonal, their rows of G = C B^T (bf16 inputs as
//     they are: exact), weighted into att in registers (the decays by
//     ex2 of base-2 cumulative sums, one FADD and one MUFU each) and used
//     as the A operand of att x, as attention feeds P to P V. 4 state
//     warps share out the state's ds/16 x HS/8 tiles, keep them in f32
//     registers across chunks, and write their split halves to shared
//     memory (two buffers, by chunk parity) for the next chunk's row
//     warps.
//   - Prefetch. Each chunk's x slice, B, C and dt go by cp.async (16
//     bytes a copy, zero-filled past S; dt 4 bytes) into one of two
//     stages while the other is computed; a chunk costs one __syncthreads.
//     Inputs whose base or strides are not 16-byte aligned are staged
//     with plain loads instead (ALIGNED = false), as correct and slower.
//   - Each warp takes the chunk's cumulative sum of dt A with shuffles
//     into its own shared row, so no barrier waits for it.
//
// ssd_fwd (f32): the first design, kept for the f32 route (it meets the
// reference's 5e-4): one CTA of 256 threads per (batch, head), the (ds,
// hd) f32 state in shared memory, the chunk's tiles staged as f32, scalar
// f32 FMAs; each thread computes a 4x4 block of the decayed C B^T, then a
// 4 x hd/16 block of y, then a ds/16 x hd/16 block of the new state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // chunk length

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD, int DS>
constexpr int smem_bytes() {
  // x [Q][HD], B and C [Q][DS+1], state [DS][HD], att [Q][Q+1],
  // lcum, dt, weights [Q], lcum_end
  return (kQ * HD + 2 * kQ * (DS + 1) + DS * HD + kQ * (kQ + 1) + 3 * kQ +
          1) * 4;
}

// ------------------------------------------- f32: scalar FMAs
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ dt,
        const float* __restrict__ A, T* __restrict__ y, int S, int NH,
        Strides xs, Strides bs, Strides cs, Strides dts) {
  constexpr int LB = DS + 1;   // padded rows: reads down a column of B or
  constexpr int LA = kQ + 1;   // C, or two rows of att, hit distinct banks
  constexpr int CJ = HD / 16;  // columns of hd per thread
  constexpr int RN = DS / 16;  // rows of ds per thread (state update)
  extern __shared__ float smem[];
  float* sx = smem;             // [kQ][HD]
  float* sb = sx + kQ * HD;     // [kQ][LB]
  float* sc = sb + kQ * LB;     // [kQ][LB]
  float* sh = sc + kQ * LB;     // [DS][HD], the carried state
  float* sa = sh + DS * HD;     // [kQ][LA], decayed C B^T times dt
  float* slc = sa + kQ * LA;    // [kQ] inclusive cumsum of dt A
  float* sdt = slc + kQ;        // [kQ]
  float* sw = sdt + kQ;         // [kQ] exp(lcum_end - lcum_s) dt_s
  float* send = sw + kQ;        // [1] lcum_end

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const T* bb = bm + b * bs.b;
  const T* cb = cm + b * cs.b;
  const float* db = dt + b * dts.b + h * dts.h;
  T* yb = y + ((long long)b * S * NH + h) * HD;  // y is contiguous

  for (int i = tid; i < DS * HD; i += kThreads) sh[i] = 0.f;

  const int n_chunks = (S + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kQ;
    __syncthreads();  // the last chunk's readers of the tiles are done
    for (int i = tid; i < kQ * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, t = t0 + r;
      sx[i] = t < S ? to_f32(xb[t * xs.s + d]) : 0.f;
    }
    for (int i = tid; i < kQ * DS; i += kThreads) {
      const int r = i / DS, n = i % DS, t = t0 + r;
      const bool ok = t < S;
      sb[r * LB + n] = ok ? to_f32(bb[t * bs.s + n]) : 0.f;
      sc[r * LB + n] = ok ? to_f32(cb[t * cs.s + n]) : 0.f;
    }
    if (tid < kQ) sdt[tid] = t0 + tid < S ? db[(t0 + tid) * dts.s] : 0.f;
    __syncthreads();

    if (tid < 32) {  // one warp: inclusive cumsum of dt A, two steps a lane
      const float a0 = sdt[2 * tid] * a, a1 = sdt[2 * tid + 1] * a;
      float v = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      float before = __shfl_up_sync(0xffffffffu, v, 1);
      if (tid == 0) before = 0.f;
      const float lc0 = before + a0;
      const float lend = __shfl_sync(0xffffffffu, v, 31);
      slc[2 * tid] = lc0;
      slc[2 * tid + 1] = v;
      sw[2 * tid] = expf(lend - lc0) * sdt[2 * tid];
      sw[2 * tid + 1] = expf(lend - v) * sdt[2 * tid + 1];
      if (tid == 0) send[0] = lend;
    }
    __syncthreads();

    {  // att[t][s] = (C_t . B_s) exp(lcum_t - lcum_s) dt_s for s <= t
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(rg + 16 * i) * LB + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sb[(cg + 16 * j) * LB + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = cg + 16 * j;
          sa[t * LA + s] =
              s <= t ? g[i][j] * expf(slc[t] - slc[s]) * sdt[s] : 0.f;
        }
      }
    }
    __syncthreads();

    {  // y = att x + exp(lcum_t) C_t . h_prev
      float acc[4][CJ], inter[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = inter[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < kQ; ++s) {
        float av[4], xv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sa[(rg + 16 * i) * LA + s];
#pragma unroll
        for (int j = 0; j < CJ; ++j) xv[j] = sx[s * HD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[4], hv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(rg + 16 * i) * LB + n];
#pragma unroll
        for (int j = 0; j < CJ; ++j) hv[j] = sh[n * HD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg + 16 * i;
        if (t0 + t >= S) continue;
        const float e = expf(slc[t]);
        T* yrow = yb + (long long)(t0 + t) * NH * HD;
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          store(yrow + cg + 16 * j, fmaf(e, inter[i][j], acc[i][j]));
      }
    }
    __syncthreads();  // every read of the old state is done

    {  // h = exp(lcum_end) h + sum_s B_s w_s x_s
      float acc[RN][CJ];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < kQ; ++s) {
        const float w = sw[s];
        float bv[RN], xv[CJ];
#pragma unroll
        for (int i = 0; i < RN; ++i) bv[i] = sb[s * LB + rg + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < CJ; ++j) xv[j] = sx[s * HD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
      const float decay = expf(send[0]);
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          float* p = sh + (rg + 16 * i) * HD + cg + 16 * j;
          *p = fmaf(decay, *p, acc[i][j]);
        }
    }
  }
}

// ------------------------------------------------ bf16: tensor cores
constexpr int kRowWarps = 4;    // warps that own 16 rows of y each
constexpr int kStateWarps = 4;  // warps that update the state
constexpr int kWarps = kRowWarps + kStateWarps;
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSlices = 2;      // CTAs a (batch, head), hd / 2 columns each
using bf16 = __nv_bfloat16;

template <int HS, int DS>
struct MmaSmem {
  static constexpr int LX = HS + 8;        // padded rows (bf16 elements):
  static constexpr int LB = DS + 8;        // 16 bytes more, conflict-free
  static constexpr int X = kQ * LX;        // x tile [kQ][LX]
  static constexpr int BC = kQ * LB;       // B or C tile [kQ][LB]
  static constexpr int H = DS * LX;        // a state half [DS][LX]
  // a stage: x, B, C (bf16), dt (f32); two stages, the state's hi and lo
  // halves in two buffers, each warp's lcum and weights (f32)
  static constexpr int STAGE = (X + 2 * BC) * 2 + kQ * 4;
  static constexpr int BYTES = 2 * STAGE + 4 * H * 2 + kWarps * 2 * kQ * 4;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(saddr(p)));
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
__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// (a, b) = hi + lo: hi the pair rounded to bf16, lo the remainder rounded
// to bf16, about 16 bits of each f32 mantissa between them
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
// 16 (or, dt, 4) bytes global -> shared, zero-filled where !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One chunk's x slice, B, C and dt into a stage (rows past S as zeros).
// ALIGNED: 16-byte cp.async copies, in flight until cp_wait_all; else
// plain loads, written by the time of the next __syncthreads.
template <int HS, int DS, bool ALIGNED>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const bf16* xb,
                                           const bf16* bb, const bf16* cb,
                                           const float* db, int t0, int S,
                                           const Strides& xs,
                                           const Strides& bs,
                                           const Strides& cs,
                                           const Strides& dts, int tid) {
  using L = MmaSmem<HS, DS>;
  bf16* sx = reinterpret_cast<bf16*>(stage);
  bf16* sb = sx + L::X;
  bf16* sc = sb + L::BC;
  float* sdt = reinterpret_cast<float*>(sc + L::BC);
  if constexpr (ALIGNED) {
    constexpr int XV = HS / 8, BV = DS / 8;  // 16-byte pieces a row
    for (int i = tid; i < kQ * XV; i += kMmaThreads) {
      const int r = i / XV, v = i % XV, t = t0 + r;
      const bool ok = t < S;
      cp16(sx + r * L::LX + 8 * v, xb + (ok ? t : 0) * xs.s + 8 * v, ok);
    }
    for (int i = tid; i < kQ * BV; i += kMmaThreads) {
      const int r = i / BV, v = i % BV, t = t0 + r;
      const bool ok = t < S;
      cp16(sb + r * L::LB + 8 * v, bb + (ok ? t : 0) * bs.s + 8 * v, ok);
      cp16(sc + r * L::LB + 8 * v, cb + (ok ? t : 0) * cs.s + 8 * v, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < kQ * HS; i += kMmaThreads) {
      const int r = i / HS, d = i % HS, t = t0 + r;
      sx[r * L::LX + d] = t < S ? xb[t * xs.s + d] : zero;
    }
    for (int i = tid; i < kQ * DS; i += kMmaThreads) {
      const int r = i / DS, n = i % DS, t = t0 + r;
      sb[r * L::LB + n] = t < S ? bb[t * bs.s + n] : zero;
      sc[r * L::LB + n] = t < S ? cb[t * cs.s + n] : zero;
    }
  }
  if (tid < kQ) {
    const int t = t0 + tid;
    cp4(sdt + tid, db + (t < S ? t : 0) * dts.s, t < S);
  }
  cp_commit();
}

// CTAs an SM the register budget is set for: two (128 registers a
// thread) up to the prefill's slice, 32 x 64 state columns by rows (where
// ptxas spills 12 bytes); one above it, where two would spill more
template <int HS, int DS>
constexpr int min_ctas() {
  return HS * DS <= 32 * 64 ? 2 : 1;
}

template <int HS, int DS, bool ALIGNED>
__global__ void __launch_bounds__(kMmaThreads, min_ctas<HS, DS>())
ssd_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ bm,
            const bf16* __restrict__ cm, const float* __restrict__ dt,
            const float* __restrict__ A, bf16* __restrict__ y, int S, int NH,
            Strides xs, Strides bs, Strides cs, Strides dts) {
  using L = MmaSmem<HS, DS>;
  constexpr int NT = HS / 8;             // n-tiles of y and of the state
  constexpr int KD = DS / 16;            // k-steps over ds
  constexpr int TILES = (DS / 16) * NT;  // the state's m16n8 tiles
  constexpr int TPW = (TILES + kStateWarps - 1) / kStateWarps;
  static_assert(HS % 16 == 0 && DS % 16 == 0, "tile sizes");
  extern __shared__ __align__(16) uint8_t dsm[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row and column pair
  // ldmatrix row addresses: lane's row in an 8x8 matrix, and which matrix
  const int lr = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int d0 = blockIdx.x * HS, h = blockIdx.y, b = blockIdx.z;
  const int HD = HS * gridDim.x;
  const float a = A[h];
  const bf16* xb = x + b * xs.b + h * xs.h + d0;
  const bf16* bb = bm + b * bs.b;
  const bf16* cb = cm + b * cs.b;
  const float* db = dt + b * dts.b + h * dts.h;
  bf16* yb = y + ((long long)b * S * NH + h) * HD + d0;  // y is contiguous

  bf16* sh = reinterpret_cast<bf16*>(dsm + 2 * L::STAGE);  // [2][hi,lo]
  float* slc = reinterpret_cast<float*>(sh + 4 * L::H) + warp * 2 * kQ;
  float* sw = slc + kQ;  // this warp's lcum log2 e and exp(lcum_end - lcum) dt

  for (int i = tid; i < 2 * L::H; i += kMmaThreads)
    sh[i] = __float2bfloat16_rn(0.f);
  float hr[TPW][4];  // this warp's state tiles, f32, across chunks
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) hr[i][e] = 0.f;

  const int n_chunks = (S + kQ - 1) / kQ;
  load_chunk<HS, DS, ALIGNED>(dsm, xb, bb, cb, db, 0, S, xs, bs, cs, dts,
                              tid);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1;
    // this chunk's stage and state halves are in place; every warp is
    // done with the last chunk's, which the next copies may overwrite
    cp_wait_all();
    __syncthreads();
    if (ch + 1 < n_chunks)
      load_chunk<HS, DS, ALIGNED>(dsm + (st ^ 1) * L::STAGE, xb, bb, cb, db,
                                  (ch + 1) * kQ, S, xs, bs, cs, dts, tid);
    const uint8_t* stage = dsm + st * L::STAGE;
    const bf16* sx = reinterpret_cast<const bf16*>(stage);
    const bf16* sb = sx + L::X;
    const bf16* sc = sb + L::BC;
    const float* sdt = reinterpret_cast<const float*>(sc + L::BC);
    const bf16* hhi = sh + st * 2 * L::H;
    const bf16* hlo = hhi + L::H;
    bf16* nhi = sh + (st ^ 1) * 2 * L::H;
    bf16* nlo = nhi + L::H;

    // inclusive cumsum of dt A, two steps a lane, into this warp's row
    const float a0 = sdt[2 * lane] * a, a1 = sdt[2 * lane + 1] * a;
    float v = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    float before = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) before = 0.f;
    const float lc0 = before + a0;
    const float lend = __shfl_sync(0xffffffffu, v, 31);
    slc[2 * lane] = lc0 * kLog2e;  // in base 2, for ex2
    slc[2 * lane + 1] = v * kLog2e;
    sw[2 * lane] = expf(lend - lc0) * sdt[2 * lane];
    sw[2 * lane + 1] = expf(lend - v) * sdt[2 * lane + 1];
    __syncwarp();

    if (warp < kRowWarps) {  // y, rows r0 .. r0 + 15 of the chunk
      const int r0 = 16 * warp;
      uint32_t ca[KD][4];        // its rows of C: A operands, k over ds
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm4(ca[kk], sc + (r0 + lr + 8 * m1) * L::LB + 16 * kk + 8 * m2);

      // y = exp(lcum_t) C_t h_prev, h_prev = hi + lo
      float yacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (16 * kk + lr + 8 * m1) * L::LX + 16 * np + 8 * m2;
          uint32_t hf[4], lf[4];
          ldsm4t(hf, hhi + off);
          ldsm4t(lf, hlo + off);
          mma(yacc[2 * np], ca[kk], hf[0], hf[1]);
          mma(yacc[2 * np + 1], ca[kk], hf[2], hf[3]);
          mma(yacc[2 * np], ca[kk], lf[0], lf[1]);
          mma(yacc[2 * np + 1], ca[kk], lf[2], lf[3]);
        }
      const float e0 = ex2(slc[r0 + g]), e1 = ex2(slc[r0 + g + 8]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }

      // y += att x, a k-step (16 steps s) at a time: att = C_t . B_s
      // exp(lcum_t - lcum_s) dt_s for s <= t, split into hi + lo A
      // operands; k-steps of s past this warp's rows are all zero
      const int nks = warp + 1;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        if (ks >= nks) continue;
        float gacc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t bf[4];
          ldsm4(bf, sb + (16 * ks + lr + 8 * m2) * L::LB + 16 * kk + 8 * m1);
          mma(gacc[0], ca[kk], bf[0], bf[1]);
          mma(gacc[1], ca[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g + 8 * (e >> 1);
            const int s = 16 * ks + 8 * j + 2 * q + (e & 1);
            gacc[j][e] = s <= t ? gacc[j][e] * ex2(slc[t] - slc[s]) * sdt[s]
                                : 0.f;
          }
        uint32_t ahi[4], alo[4];
        split(gacc[0][0], gacc[0][1], ahi[0], alo[0]);
        split(gacc[0][2], gacc[0][3], ahi[1], alo[1]);
        split(gacc[1][0], gacc[1][1], ahi[2], alo[2]);
        split(gacc[1][2], gacc[1][3], ahi[3], alo[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t xf[4];
          ldsm4t(xf, sx + (16 * ks + lr + 8 * m1) * L::LX + 16 * np + 8 * m2);
          mma(yacc[2 * np], ahi, xf[0], xf[1]);
          mma(yacc[2 * np + 1], ahi, xf[2], xf[3]);
          mma(yacc[2 * np], alo, xf[0], xf[1]);
          mma(yacc[2 * np + 1], alo, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = ch * kQ + r0 + g + 8 * half;
        if (t >= S) continue;
        bf16* yrow = yb + (long long)t * NH * HD + 2 * q;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * j) =
              __floats2bfloat162_rn(yacc[j][2 * half], yacc[j][2 * half + 1]);
      }

    } else {
      // h = exp(lcum_end) h + sum_s B_s (w_s x_s), w x = hi + lo; then the
      // new state's halves for the next chunk's C h_prev (the other buffer:
      // the row warps read this chunk's at the same time)
      const float decay = expf(lend);
      const int sw_id = warp - kRowWarps;
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[i][e] *= decay;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        // w x for the state's columns 8 nj .. 8 nj + 7, as hi + lo B
        // operands (with NT <= kStateWarps a warp's tiles share one nj)
        uint32_t wh[2], wl[2];
        auto weigh = [&](int nj) {
          uint32_t xf[2];
          ldsm2t(xf, sx + (16 * ks + lr + 8 * m1) * L::LX + 8 * nj);
          const int s = 16 * ks + 2 * q;
          const float2 x0 = unpack(xf[0]), x1 = unpack(xf[1]);
          split(x0.x * sw[s], x0.y * sw[s + 1], wh[0], wl[0]);
          split(x1.x * sw[s + 8], x1.y * sw[s + 9], wh[1], wl[1]);
        };
        if constexpr (NT <= kStateWarps) weigh(sw_id % NT);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int tile = sw_id + kStateWarps * i;
          if (tile >= TILES) continue;
          const int mi = tile / NT, nj = tile % NT;
          if constexpr (NT > kStateWarps) weigh(nj);
          uint32_t bt[4];
          ldsm4t(bt, sb + (16 * ks + lr + 8 * m2) * L::LB + 16 * mi + 8 * m1);
          mma(hr[i], bt, wh[0], wh[1]);
          mma(hr[i], bt, wl[0], wl[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int tile = sw_id + kStateWarps * i;
        if (tile >= TILES) continue;
        const int row = 16 * (tile / NT) + g, col = 8 * (tile % NT) + 2 * q;
        uint32_t hi, lo;
        split(hr[i][0], hr[i][1], hi, lo);
        *reinterpret_cast<uint32_t*>(nhi + row * L::LX + col) = hi;
        *reinterpret_cast<uint32_t*>(nlo + row * L::LX + col) = lo;
        split(hr[i][2], hr[i][3], hi, lo);
        *reinterpret_cast<uint32_t*>(nhi + (row + 8) * L::LX + col) = hi;
        *reinterpret_cast<uint32_t*>(nlo + (row + 8) * L::LX + col) = lo;
      }
    }
  }
  cp_wait_all();  // S = 0: the first chunk's copies, never waited for
}

// The dynamic shared-memory limit of `kernel` raised once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *A;
  void* y;
  int B, S, NH, HD;
  Strides xs, bs, cs, dts;
  cudaStream_t stream;
};

template <int HD, int DS>
cudaError_t launch_f32(const Args& p) {
  static bool ready[64] = {false};
  cudaError_t err = allow_smem(ssd_fwd<float, HD, DS>, smem_bytes<HD, DS>(),
                               ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.NH, p.B);
  ssd_fwd<float, HD, DS><<<grid, kThreads, smem_bytes<HD, DS>(), p.stream>>>(
      static_cast<const float*>(p.x), static_cast<const float*>(p.bm),
      static_cast<const float*>(p.cm), p.dt, p.A, static_cast<float*>(p.y),
      p.S, p.NH, p.xs, p.bs, p.cs, p.dts);
  return cudaGetLastError();
}

template <int HS, int DS, bool ALIGNED>
cudaError_t launch_mma(const Args& p) {
  static bool ready[64] = {false};
  constexpr int bytes = MmaSmem<HS, DS>::BYTES;
  cudaError_t err = allow_smem(ssd_fwd_mma<HS, DS, ALIGNED>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.HD / HS, p.NH, p.B);
  ssd_fwd_mma<HS, DS, ALIGNED><<<grid, kMmaThreads, bytes, p.stream>>>(
      static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.bm),
      static_cast<const bf16*>(p.cm), p.dt, p.A, static_cast<bf16*>(p.y),
      p.S, p.NH, p.xs, p.bs, p.cs, p.dts);
  return cudaGetLastError();
}

template <int DS>
cudaError_t by_alignment(const Args& p) {
  // 16-byte cp.async copies need 16-byte aligned rows of x, B and C
  auto al = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  auto al8 = [](const Strides& s) {
    return s.b % 8 == 0 && s.s % 8 == 0 && s.h % 8 == 0;
  };
  if (al(p.x) && al(p.bm) && al(p.cm) && al8(p.xs) && al8(p.bs) &&
      al8(p.cs))
    return launch_mma<64 / kSlices, DS, true>(p);
  return launch_mma<64 / kSlices, DS, false>(p);
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32 (the scalar kernel), 1 bfloat16 (the
// tensor-core kernel). Strides are in elements; B and C have no head
// stride. y is a contiguous (B, S, NH, HD) tensor. Returns a CUDA error
// code (0 on success); cudaErrorInvalidValue for a head size, state size
// or type the library was not built for.
int ssd_chunk_launch(const void* x, const void* bm, const void* cm,
                     const void* dt, const void* A, void* y, int B, int S,
                     int NH, int HD, int DS, int dtype, long long x_sb,
                     long long x_ss, long long x_sh, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss,
                     long long dt_sb, long long dt_ss, long long dt_sh,
                     void* stream) {
  const Args p{x, bm, cm, static_cast<const float*>(dt),
               static_cast<const float*>(A), y, B, S, NH, HD,
               Strides{x_sb, x_ss, x_sh}, Strides{b_sb, b_ss, 0},
               Strides{c_sb, c_ss, 0}, Strides{dt_sb, dt_ss, dt_sh},
               static_cast<cudaStream_t>(stream)};
  if (HD != 64 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (DS == 16) return launch_f32<64, 16>(p);
    if (DS == 64) return launch_f32<64, 64>(p);
    if (DS == 128) return launch_f32<64, 128>(p);
    return cudaErrorInvalidValue;
  }
  if (DS == 16) return by_alignment<16>(p);
  if (DS == 64) return by_alignment<64>(p);
  if (DS == 128) return by_alignment<128>(p);
  return cudaErrorInvalidValue;
}

}  // extern "C"
