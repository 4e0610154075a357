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
// is rounded once to x's type.
//
// Bound on an H100 SXM at the falcon-mamba-7b prefill, B = 2, S = 4096,
// di = 8192, ds = 16, bf16: the function reads x and dt and writes y
// (402,653,184 bytes) and reads B, C, A, D (1,081,344 bytes), about
// 0.1205 ms at 3.35 TB/s. It takes B S di ds = 1,073,741,824
// exponentials; the special-function units return 16 a clock per SM
// (CUDA C++ Programming Guide, arithmetic throughput, compute capability
// 9.0), so 132 SMs at 1,980 MHz need about 0.257 ms. The float32 work
// the function needs around them (six operations an exponential) is about
// 0.096 ms at 67 TFLOP/s. So the exponentials, not the bytes, bound it:
// a warp's exponential holds its SM quarter's special-function unit for 8
// clocks, in which the quarter can issue 8 other instructions, so the
// kernel reaches the bound only with at most about 8 instructions a
// state-step in all.
//
// Design: the TPU's grid (batch, di/256), run in order with a (256, ds)
// state in VMEM, becomes 128-thread CTAs of kChannels = 32 channels each,
// grid (ceil(di/32), B): 512 CTAs of 4 warps at the prefill, 16 warps an
// SM (2 or 8 lanes a channel, or 256- and 512-thread CTAs, timed slower:
// chip_faults.py's probes, PERF.md). Each channel's ds states are split
// over kLanes = 4 neighbouring lanes (ds/4 states and the matching slice
// of A's row in registers each). Time runs in tiles of kT = 64 steps: the
// tile's x and dt (coalesced across channels) and B and C (shared by
// every channel of the batch element) are staged in shared memory, and y
// is staged there and stored a tile at a time, coalesced. The next tile's
// loads are issued into registers, raw, before the current tile is
// computed and converted only when staged, so they are in flight during
// it; the load and store addresses step on by a tile (no index is
// multiplied out). Steps past S load as zeros (dt = 0: no decay, no
// input) and are not stored; channels past di are masked. Inputs are
// read through their batch and sequence strides (last dimension
// contiguous), so B and C, slices of one packed projection in the model,
// need no copy. Under grad the wrapper passes a states buffer, and the
// kernel writes the f32 state entering each tile there for the backward
// kernel (csrc/selective_scan_bwd.cu), which recomputes a tile from it.
//
// What a state-step costs, and what the design does about it (SASS of the
// bf16 ds 16 inner loop, chip_smoke.py phase 1: 8.4 instructions a
// state-step):
//   - The decay. The accurate expf(dt A) is about 8 FP32 and integer
//     instructions around one MUFU.EX2. The bf16 route takes instead
//     ex2.approx(dt (A log2 e)), with A log2 e held per lane as a hi + lo
//     pair of floats (about 48 bits, computed once in double): the
//     argument is fmaf(dt, hi, dt lo), so it carries no rounding of
//     A log2 e, which, the same for every step of a channel, would bias
//     a slowly decaying state's long memory. Two FP32 instructions and
//     one MUFU. The f32 route keeps expf (CheapDecay<float>), the decay
//     of the plain version on the card: with ex2.approx it missed the
//     reference's 1e-4 over 4096 slowly decaying steps (2.9e-4 abs), with
//     or without the low part, so the special-function unit's own error,
//     not the argument's rounding, is what drifts.
//   - Per step, not per state: dt and dt x are formed once, when the tile
//     is staged, and read as one 8-byte shared load; D x is added when y
//     is stored; each lane's slice of B and of C is one 16-byte load each.
//   - The sum of y over the lanes: kLanes steps at a time, each lane keeps
//     its part of C . h for each, then log2(kLanes) rounds of shuffles
//     reduce-scatter them so that lane q holds step q's y: 3 shuffles a 4
//     steps in place of 8, and no step waits for the last one's sum.
//   - What is left a state: the decay (3), the update's dt x B product
//     and multiply-add (2), and C . h's multiply-add (1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                      // lanes a channel
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;   // channels a CTA
constexpr int kT = 2048 / kChannels;           // time steps a tile
constexpr int kRowsPerPass = kThreads / kChannels;
constexpr double kLog2e = 1.4426950408889634;

struct Strides {
  long long b, s;
};

// Which decay a route takes: ex2.approx of the hi + lo argument (true) or
// the accurate expf (false)
template <typename T>
struct CheapDecay {
  static constexpr bool value = true;
};
template <>
struct CheapDecay<float> {
  static constexpr bool value = false;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// N floats from shared memory aligned to 4 N bytes, in 16- or 8-byte loads
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
         const T* __restrict__ bm, const T* __restrict__ cm,
         const float* __restrict__ A, const float* __restrict__ Dv,
         T* __restrict__ y, float* __restrict__ states, int S, int DI,
         Strides xs, Strides dts, Strides bs, Strides cs) {
  constexpr int SPL = DS / kLanes;                // states a lane
  constexpr int XPT = kT * kChannels / kThreads;  // x, dt loads a thread
  constexpr int BPT = (kT * DS + kThreads - 1) / kThreads;  // B, C loads
  constexpr bool kCheap = CheapDecay<T>::value;
  static_assert(DS % kLanes == 0, "ds");
  static_assert(kT % kLanes == 0, "a tile is whole groups of kLanes steps");
  __shared__ float2 sv[kT][kChannels];  // a (step, channel): {dt, dt x}
  __shared__ float sd[kT][kChannels];   // D x
  __shared__ __align__(16) float sb[kT][DS];
  __shared__ __align__(16) float sc[kT][DS];
  __shared__ float sy[kT][kChannels];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  // compute: channel ch, lane q holding states q*SPL .. q*SPL + SPL - 1
  const int ch = tid / kLanes, q = tid % kLanes;
  const bool live = d0 + ch < DI;
  // loads and stores: column lc, rows lr, lr + kRowsPerPass, ...
  const int lc = tid % kChannels, lr = tid / kChannels;
  const bool lcol = d0 + lc < DI;

  float a[SPL], a2hi[SPL], a2lo[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const float aj = live ? A[(long long)(d0 + ch) * DS + q * SPL + j] : 0.f;
    const double a2 = (double)aj * kLog2e;  // A log2 e, hi + lo
    a[j] = aj;
    a2hi[j] = (float)a2;
    a2lo[j] = (float)(a2 - (double)a2hi[j]);
    h[j] = 0.f;
  }
  const float dl = lcol ? Dv[d0 + lc] : 0.f;  // D of the loaded column

  // this thread's first element of the next tile in x and dt (row lr,
  // column lc), in B and C (element tid of the [kT][DS] tile) and in y;
  // each tile moves them on kT rows, so no index is multiplied out
  constexpr int kBRows = kThreads / DS;  // B rows between a thread's loads
  static_assert(kThreads % DS == 0, "ds");
  const T* xn = x + b * xs.b + lr * xs.s + d0 + lc;
  const T* dn = dt + b * dts.b + lr * dts.s + d0 + lc;
  const T* bn = bm + b * bs.b + (tid / DS) * bs.s + tid % DS;
  const T* cn = cm + b * cs.b + (tid / DS) * cs.s + tid % DS;
  T* yn = y + ((long long)b * S + lr) * DI + d0 + lc;  // y is contiguous

  // the next tile, raw: converted only when staged, so no instruction
  // waits for the loads before the current tile is computed
  T px[XPT], pdt[XPT], pb[BPT], pc[BPT];
  const T zero = from_f32<T>(0.f);
  auto fetch = [&](int t0) {
    const T *xk = xn, *dk = dn, *bk = bn, *ck = cn;
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const bool ok = lcol && t0 + lr + kRowsPerPass * k < S;
      px[k] = ok ? *xk : zero;
      pdt[k] = ok ? *dk : zero;
      xk += kRowsPerPass * xs.s;
      dk += kRowsPerPass * dts.s;
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const bool ok = t0 + tid / DS + kBRows * k < S &&
                      tid + kThreads * k < kT * DS;
      pb[k] = ok ? *bk : zero;
      pc[k] = ok ? *ck : zero;
      bk += kBRows * bs.s;
      ck += kBRows * cs.s;
    }
    xn += kT * xs.s;
    dn += kT * dts.s;
    bn += kT * bs.s;
    cn += kT * cs.s;
  };

  const int n_tiles = (S + kT - 1) / kT;
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kT;
    if (states && live) {  // under grad: the state entering this tile
      float* out = states +
                   (((long long)b * n_tiles + tile) * DI + d0 + ch) * DS +
                   q * SPL;
#pragma unroll
      for (int j = 0; j < SPL; ++j) out[j] = h[j];
    }
    __syncthreads();  // the last tile's readers of the shared tiles are done
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const float xv = to_f32(px[k]), dv = to_f32(pdt[k]);
      sv[lr + kRowsPerPass * k][lc] = make_float2(dv, dv * xv);
      sd[lr + kRowsPerPass * k][lc] = dl * xv;
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int i = tid + kThreads * k;
      if (i >= kT * DS) break;
      sb[i / DS][i % DS] = to_f32(pb[k]);
      sc[i / DS][i % DS] = to_f32(pc[k]);
    }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(t0 + kT);  // in flight during this tile

    // kLanes steps at a time: each lane keeps its part of C . h for each
    // step, and the lanes then reduce-scatter them (log2(kLanes) rounds of
    // shuffles), so lane q ends with step r0 + q's y. No step waits for
    // the last one's sum: only the states chain the steps together.
#pragma unroll 1
    for (int r0 = 0; r0 < kT; r0 += kLanes) {
      float part[kLanes];
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        const int r = r0 + u;
        const float2 v = sv[r][ch];  // dt, dt x
        float bv[SPL], cv[SPL];
        lds(bv, &sb[r][q * SPL]);
        lds(cv, &sc[r][q * SPL]);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          float da;
          if constexpr (kCheap)
            da = ex2(fmaf(v.x, a2hi[j], v.x * a2lo[j]));
          else
            da = expf(v.x * a[j]);
          h[j] = fmaf(da, h[j], v.y * bv[j]);
          acc = fmaf(h[j], cv[j], acc);
        }
        part[u] = acc;
      }
#pragma unroll
      for (int half = kLanes / 2; half >= 1; half /= 2) {
        const bool upper = q & half;  // keeps the upper half of the steps
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = upper ? part[i] : part[i + half];
          const float keep = upper ? part[i + half] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
        }
      }
      sy[r0 + q][ch] = part[0];
    }
    __syncthreads();
    T* yk = yn;
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int r = lr + kRowsPerPass * k;
      if (lcol && t0 + r < S) *yk = from_f32<T>(sy[r][lc] + sd[r][lc]);
      yk += kRowsPerPass * DI;
    }
    yn += (long long)kT * DI;
  }
}

template <typename T, int DS>
cudaError_t launch(const void* x, const void* dt, const void* bm,
                   const void* cm, const float* A, const float* Dv, void* y,
                   float* states, int B, int S, int DI, Strides xs,
                   Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  const dim3 grid((DI + kChannels - 1) / kChannels, B);
  scan_fwd<T, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), A, Dv,
      static_cast<T*>(y), states, S, DI, xs, dts, bs, cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* bm,
                     const void* cm, const float* A, const float* Dv, void* y,
                     float* states, int B, int S, int DI, int DS, Strides xs,
                     Strides dts, Strides bs, Strides cs, cudaStream_t st) {
  if (DS == 8)
    return launch<T, 8>(x, dt, bm, cm, A, Dv, y, states, B, S, DI, xs, dts,
                        bs, cs, st);
  if (DS == 16)
    return launch<T, 16>(x, dt, bm, cm, A, Dv, y, states, B, S, DI, xs, dts,
                         bs, cs, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of x, dt, B, C and y): 0 float32, 1 bfloat16. Strides are in
// elements, batch then sequence; each last dimension is contiguous. y is a
// contiguous (B, S, DI) tensor, A a contiguous (DI, DS) and D a (DI,)
// float32 tensor. states is null, or (under grad) a contiguous (B,
// ceil(S / 64), DI, DS) float32 tensor that receives the state entering
// each 64-step tile. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a state size or type the library was not built
// for.
int selective_scan_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* A, const void* D,
                          void* y, void* states, int B, int S, int DI,
                          int DS, int dtype,
                          long long x_sb, long long x_ss, long long dt_sb,
                          long long dt_ss, long long b_sb, long long b_ss,
                          long long c_sb, long long c_ss, void* stream) {
  const Strides xs{x_sb, x_ss}, dts{dt_sb, dt_ss}, bs{b_sb, b_ss},
      cs{c_sb, c_ss};
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  float* sp = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, bm, cm, Ap, Dp, y, sp, B, S, DI, DS, xs,
                           dts, bs, cs, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, bm, cm, Ap, Dp, y, sp, B, S, DI,
                                   DS, xs, dts, bs, cs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
