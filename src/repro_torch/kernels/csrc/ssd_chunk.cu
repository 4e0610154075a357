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
// dt (B, S, nh) and A (nh,) in f32; all arithmetic is f32 and y is rounded
// once to x's type.
//
// Bound on an H100 SXM: at B = 2, S = 4096, nh = 64, hd = 64, ds = 64 in
// bf16 the function reads x (67 MB), B, C and dt (about 4 MB) and writes y
// (67 MB): about 0.041 ms at 3.35 TB/s. Its chunked arithmetic is four
// 64 x 64 x 64 products per chunk (C B^T, att x, C h, B^T x), 2.1 MFLOP,
// so 17.2 GFLOP per call over 64 chunks and 128 (batch, head) pairs:
// 0.017 ms of bf16 tensor-core work. It is bound by bytes. This first
// design is correct and simple, not at that bound: the products are scalar
// f32 FMAs, and one CTA per (batch, head) gives 128 CTAs of 8 warps, about
// one per SM of the 132, which leaves most of each SM's warp slots empty
// and so does not fill the card's latency hiding.
//
// Design: the TPU's chunk loop (a fori_loop over VMEM blocks) becomes a
// loop inside the CTA. The (ds, hd) f32 state stays in shared memory for
// the whole sequence (16 KB at 64 x 64), so each input byte is read from
// device memory once and y is written once. Per chunk: the chunk's x, B, C
// and dt are loaded into shared memory as f32 (rows past S as zeros, which
// leaves the recurrence unchanged: dt = 0 means no decay and no input); one
// warp takes the inclusive cumulative sum of dt A with shuffles; each of
// the 256 threads computes a 4x4 block of the 64x64 decayed C B^T, then a
// 4 x hd/16 block of y (intra-chunk product plus the inter-chunk term from
// the old state), then a ds/16 x hd/16 block of the new state. x, B, C are
// read through their batch and sequence (and head) strides, so the model's
// slices of one packed projection go in without a copy.

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD, int DS>
constexpr int smem_bytes() {
  // x [Q][HD], B and C [Q][DS+1], state [DS][HD], att [Q][Q+1],
  // lcum, dt, weights [Q], lcum_end
  return (kQ * HD + 2 * kQ * (DS + 1) + DS * HD + kQ * (kQ + 1) + 3 * kQ +
          1) * 4;
}

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

template <typename T, int HD, int DS>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const float* dt, const float* A, void* y, int B, int S,
                   int NH, Strides xs, Strides bs, Strides cs, Strides dts,
                   cudaStream_t stream) {
  static bool ready[64] = {false};  // shared-memory limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(ssd_fwd<T, HD, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<HD, DS>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid(NH, B);
  ssd_fwd<T, HD, DS><<<grid, kThreads, smem_bytes<HD, DS>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), dt, A, static_cast<T*>(y), S, NH, xs, bs, cs,
      dts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* bm, const void* cm,
                     const float* dt, const float* A, void* y, int B, int S,
                     int NH, int HD, int DS, Strides xs, Strides bs,
                     Strides cs, Strides dts, cudaStream_t st) {
  if (HD != 64) return cudaErrorInvalidValue;
  if (DS == 16)
    return launch<T, 64, 16>(x, bm, cm, dt, A, y, B, S, NH, xs, bs, cs, dts,
                             st);
  if (DS == 64)
    return launch<T, 64, 64>(x, bm, cm, dt, A, y, B, S, NH, xs, bs, cs, dts,
                             st);
  if (DS == 128)
    return launch<T, 64, 128>(x, bm, cm, dt, A, y, B, S, NH, xs, bs, cs, dts,
                              st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. Strides are in
// elements; B and C have no head stride. y is a contiguous (B, S, NH, HD)
// tensor. Returns a CUDA error code (0 on success); cudaErrorInvalidValue
// for a head size, state size or type the library was not built for.
int ssd_chunk_launch(const void* x, const void* bm, const void* cm,
                     const void* dt, const void* A, void* y, int B, int S,
                     int NH, int HD, int DS, int dtype, long long x_sb,
                     long long x_ss, long long x_sh, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss,
                     long long dt_sb, long long dt_ss, long long dt_sh,
                     void* stream) {
  const Strides xs{x_sb, x_ss, x_sh}, bs{b_sb, b_ss, 0}, cs{c_sb, c_ss, 0},
      dts{dt_sb, dt_ss, dt_sh};
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, bm, cm, dtp, Ap, y, B, S, NH, HD, DS, xs, bs,
                           cs, dts, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, bm, cm, dtp, Ap, y, B, S, NH, HD, DS,
                                   xs, bs, cs, dts, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
