// Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// (_scan_kernel, selective_scan): for each batch element b and channel d,
// with a state h of ds values,
//     h_t = exp(dt_t A_d) (.) h_{t-1} + (dt_t x_t) B_t,
//     y_t = C_t . h_t + D_d x_t,
// sequential in t, no softplus inside (dt comes after it) and the D skip
// included. x, dt and y are (B, S, di) in bf16 or f32, B and C (B, S, ds)
// in x's type, A (di, ds) and D (di,) in f32. All arithmetic is f32 and y
// is rounded once to x's type. The decay is expf(dt * A), the accurate
// expf (one ex2 on the special-function unit and a few FMAs around it per
// (b, t, d, state)): the same product and function as the plain version's
// torch.exp on the card. exp2f(dt * (A log2 e)) saves those FMAs, but
// drifted from it by a little each step, which a long memory adds up:
// 2.9e-4 abs in f32 at S = 4096 with dt about 0.02, beyond the
// reference's 1e-4.
//
// Bound on an H100 SXM at the falcon-mamba-7b prefill, B = 2, S = 4096,
// di = 8192, ds = 16, bf16: the function reads x and dt and writes y
// (402,653,184 bytes) and reads B, C, A, D (1,081,344 bytes), about
// 0.1205 ms at 3.35 TB/s. It takes B S di ds = 1,073,741,824
// exponentials; the special-function units return 16 a clock per SM
// (CUDA C++ Programming Guide, arithmetic throughput, compute capability
// 9.0), so 132 SMs at 1,980 MHz need about 0.257 ms. The float32 work
// the function needs around them (six operations an exponential) is about
// 0.096 ms at 67 TFLOP/s. So the exponentials, not the bytes, bound it.
//
// Design: the TPU's grid (batch, di/256), run in order with a (256, ds)
// state in VMEM, becomes 256-thread CTAs of 64 channels each, grid
// (ceil(di/64), B): 256 CTAs of 8 warps at the prefill, two an SM. Each
// channel's ds states are split over 4 neighbouring lanes (ds/4 states
// and the matching slice of A's row in registers each), so a warp carries 8
// channels and there are four times as many warps to hide latency as with
// a thread per channel; the lanes sum their parts of y with two shuffles.
// Time runs in tiles of 32 steps: the tile's x and dt ([32][64], coalesced
// across channels) and B and C ([32][ds], shared by every channel of the
// batch element) are staged in shared memory as f32, and y is staged there
// and stored a tile at a time, coalesced. The next tile's loads are issued
// into registers before the current tile is computed, so they are in
// flight during it. Steps past S load as zeros (dt = 0: no decay, no
// input) and are not stored; channels past di are masked. Inputs are read
// through their batch and sequence strides (last dimension contiguous), so
// B and C, slices of one packed projection in the model, need no copy.
// A time-chunked parallel scan (upstream Mamba's CUDA kernel) and a balance
// between the special-function and FMA units are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;                  // channels a CTA
constexpr int kLanes = 4;                      // lanes a channel
constexpr int kThreads = kChannels * kLanes;   // 256
constexpr int kT = 32;                         // time steps a tile
constexpr int kRowsPerPass = kThreads / kChannels;

struct Strides {
  long long b, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
         const T* __restrict__ bm, const T* __restrict__ cm,
         const float* __restrict__ A, const float* __restrict__ Dv,
         T* __restrict__ y, int S, int DI, Strides xs, Strides dts,
         Strides bs, Strides cs) {
  constexpr int SPL = DS / kLanes;                // states a lane
  constexpr int XPT = kT * kChannels / kThreads;  // x, dt loads a thread
  constexpr int BPT = kT * DS / kThreads;         // B, C loads a thread
  static_assert(DS % kLanes == 0 && (kT * DS) % kThreads == 0, "ds");
  __shared__ float sx[kT][kChannels], sdt[kT][kChannels], sy[kT][kChannels];
  __shared__ float sb[kT][DS], sc[kT][DS];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  // compute: channel ch, lane q holding states q*SPL .. q*SPL + SPL - 1
  const int ch = tid / kLanes, q = tid % kLanes;
  const bool live = d0 + ch < DI;
  // loads and stores: column lc, rows lr, lr + kRowsPerPass, ...
  const int lc = tid % kChannels, lr = tid / kChannels;
  const bool lcol = d0 + lc < DI;

  float a[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    a[j] = live ? A[(long long)(d0 + ch) * DS + q * SPL + j] : 0.f;
    h[j] = 0.f;
  }
  const float dd = live ? Dv[d0 + ch] : 0.f;

  const T* xb = x + b * xs.b + d0 + lc;
  const T* db = dt + b * dts.b + d0 + lc;
  const T* bb = bm + b * bs.b;
  const T* cb = cm + b * cs.b;
  T* yb = y + (long long)b * S * DI + d0 + lc;  // y is contiguous

  float px[XPT], pdt[XPT], pb[BPT], pc[BPT];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int t = t0 + lr + kRowsPerPass * k;
      const bool ok = lcol && t < S;
      px[k] = ok ? to_f32(xb[t * xs.s]) : 0.f;
      pdt[k] = ok ? to_f32(db[t * dts.s]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int i = tid + kThreads * k;
      const int t = t0 + i / DS, n = i % DS;
      const bool ok = t < S;
      pb[k] = ok ? to_f32(bb[t * bs.s + n]) : 0.f;
      pc[k] = ok ? to_f32(cb[t * cs.s + n]) : 0.f;
    }
  };

  const int n_tiles = (S + kT - 1) / kT;
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kT;
    __syncthreads();  // the last tile's readers of the shared tiles are done
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      sx[lr + kRowsPerPass * k][lc] = px[k];
      sdt[lr + kRowsPerPass * k][lc] = pdt[k];
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int i = tid + kThreads * k;
      sb[i / DS][i % DS] = pb[k];
      sc[i / DS][i % DS] = pc[k];
    }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(t0 + kT);  // in flight during this tile

#pragma unroll 4
    for (int r = 0; r < kT; ++r) {
      const float xt = sx[r][ch], dtt = sdt[r][ch];
      const float dx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int n = q * SPL + j;
        const float da = expf(dtt * a[j]);
        h[j] = fmaf(da, h[j], dx * sb[r][n]);
        acc = fmaf(h[j], sc[r][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) sy[r][ch] = fmaf(dd, xt, acc);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int r = lr + kRowsPerPass * k, t = t0 + r;
      if (lcol && t < S) store(yb + (long long)t * DI, sy[r][lc]);
    }
  }
}

template <typename T, int DS>
cudaError_t launch(const void* x, const void* dt, const void* bm,
                   const void* cm, const float* A, const float* Dv, void* y,
                   int B, int S, int DI, Strides xs, Strides dts, Strides bs,
                   Strides cs, cudaStream_t stream) {
  const dim3 grid((DI + kChannels - 1) / kChannels, B);
  scan_fwd<T, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), A, Dv,
      static_cast<T*>(y), S, DI, xs, dts, bs, cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* bm,
                     const void* cm, const float* A, const float* Dv, void* y,
                     int B, int S, int DI, int DS, Strides xs, Strides dts,
                     Strides bs, Strides cs, cudaStream_t st) {
  if (DS == 8)
    return launch<T, 8>(x, dt, bm, cm, A, Dv, y, B, S, DI, xs, dts, bs, cs,
                        st);
  if (DS == 16)
    return launch<T, 16>(x, dt, bm, cm, A, Dv, y, B, S, DI, xs, dts, bs, cs,
                         st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of x, dt, B, C and y): 0 float32, 1 bfloat16. Strides are in
// elements, batch then sequence; each last dimension is contiguous. y is a
// contiguous (B, S, DI) tensor, A a contiguous (DI, DS) and D a (DI,)
// float32 tensor. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a state size or type the library was not built
// for.
int selective_scan_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* A, const void* D,
                          void* y, int B, int S, int DI, int DS, int dtype,
                          long long x_sb, long long x_ss, long long dt_sb,
                          long long dt_ss, long long b_sb, long long b_ss,
                          long long c_sb, long long c_ss, void* stream) {
  const Strides xs{x_sb, x_ss}, dts{dt_sb, dt_ss}, bs{b_sb, b_ss},
      cs{c_sb, c_ss};
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, bm, cm, Ap, Dp, y, B, S, DI, DS, xs, dts,
                           bs, cs, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, bm, cm, Ap, Dp, y, B, S, DI, DS,
                                   xs, dts, bs, cs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
