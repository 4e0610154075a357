// The gradient of the Mamba1 selective scan (csrc/selective_scan.cu) for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its lax.scan
// (src/repro/models/mamba.py:84-106) with jax.grad, and the Pallas
// selective_scan (src/repro/kernels/selective_scan.py) has no backward.
// For each batch element b and channel d, with a = exp(dt_t A_d) and the
// state h_t = a h_{t-1} + dt_t x_t B_t of ds values, y_t = C_t . h_t +
// D_d x_t and g_t = C_t dy_t + a_{t+1} g_{t+1} (the loss's gradient with
// respect to h_t), it computes
//     dx_t  = dt_t sum_s g_t B_t + D dy_t        (B, S, di), x's type
//     ddt_t = sum_s g_t (A a h_{t-1} + x_t B_t)  (B, S, di), dt's type
//     dB_t  = sum_d g_t dt_t x_t                 (B, S, ds), f32 sums
//     dC_t  = sum_d dy_t h_t                     (B, S, ds), f32 sums
//     dA    = sum_{b,t} g_t dt_t a h_{t-1}       (di, ds), f32
//     dD    = sum_{b,t} dy_t x_t                 (di,), f32
// from x, dt, B, C (one type, read through their batch and sequence
// strides), A and D (f32), dy, and the state entering each 64-step tile,
// which the forward kernel writes under grad ((B, ceil(S/64), di, ds)
// f32). All arithmetic is f32; the decay is the accurate expf on both
// routes (ex2.approx drifted 2.9e-4 over 4,096 slowly decaying steps in
// the forward, beyond the reference's 1e-4).
//
// Design (the first, simple kernel; a Hopper redesign is later work): the
// forward's CTAs, 128 threads and kChannels = 32 channels each, grid
// (ceil(di/32), B), each channel's ds states split over kLanes = 4
// neighbouring lanes; time runs in the forward's tiles of kT = 64 steps,
// last tile first, with g carried in registers. A tile's x, dt, dy, B and
// C are staged in shared memory as f32. The tile is recomputed from its
// entering state in two levels: a first pass runs it forward and keeps the
// state at each kSub = 8-step boundary (shared memory, private to the
// thread); then, sub-tile by sub-tile from the last, the 8 steps are run
// again with each step's decay and entering state kept in registers, and
// walked back: g, dx and ddt (summed over the lanes by shuffles), dA in
// registers. So a state-step costs two expf. dB and dC sum over all di
// channels, which are other CTAs: each thread stages its g dt x and dy h
// for the sub-tile in shared memory, the CTA sums its 32 channels, and the
// sums are added into f32 buffers with atomicAdd (red.global.add.f32), so
// the order of the ceil(di/32) additions changes from run to run (about
// 1e-7 relative in f32). dA and dD add one value a thread across the
// batch. Steps past S load as zeros (dt = 0: no decay, no input, no
// gradient) and are not stored; channels past di are masked.
//
// Bound on an H100 SXM at falcon-mamba-7b's train step, B = 4, S = 4096,
// di = 8192, ds = 16, bf16: the least work is one exponential per
// state-step, B S di ds = 2,147,483,648 of them; the special-function
// units return 16 a clock per SM (CUDA C++ Programming Guide, arithmetic
// throughput, compute capability 9.0), so 132 SMs at 1,980 MHz need
// 0.5136 ms. The function reads x, dt and dy and writes dx and ddt
// (5 x 268,435,456 bytes) and reads B, C, A, D and writes dB and dC
// (about 2.2 MB): 1.34 GB, 0.4014 ms at 3.35 TB/s. The exponentials bound
// it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                      // lanes a channel
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;   // channels a CTA
constexpr int kT = 64;                         // the forward's tile
constexpr int kSub = 8;                        // steps a sub-tile
constexpr int kNSub = kT / kSub;
constexpr int kRowsPerPass = kThreads / kChannels;

struct Strides {
  long long b, s;
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
// N floats to / from shared memory aligned to 4 N bytes
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
  } else {
    static_assert(N % 2 == 0, "even");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    static_assert(N % 2 == 0, "even");
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

template <int DS>
struct Smem {
  static constexpr int SPL = DS / kLanes;
  static constexpr int COL = kT * kChannels;     // a [kT][kChannels] tile
  static constexpr int RED = kChannels * DS + 16;  // a sub-tile step, padded
  // {dt, dt x}, x, dy; B, C; checkpoints; g dt x and dy h; dx, ddt
  static constexpr int V = 0, X = V + 2 * COL, DY = X + COL, B = DY + COL,
                       C = B + kT * DS, CK = C + kT * DS,
                       RB = CK + kNSub * kThreads * SPL, RC = RB + kSub * RED,
                       DX = RC + kSub * RED, DDT = DX + COL,
                       FLOATS = DDT + COL;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
scan_bwd(const T* __restrict__ x, const T* __restrict__ dt,
         const T* __restrict__ bm, const T* __restrict__ cm,
         const float* __restrict__ A, const float* __restrict__ Dv,
         const T* __restrict__ dy, const float* __restrict__ states,
         T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dbm,
         float* __restrict__ dcm, float* __restrict__ dA,
         float* __restrict__ dD, int S, int DI, Strides xs, Strides dts,
         Strides bs, Strides cs, Strides dys) {
  using L = Smem<DS>;
  constexpr int SPL = L::SPL;                     // states a lane
  constexpr int XPT = kT * kChannels / kThreads;  // x, dt, dy loads a thread
  static_assert(DS % kLanes == 0 && SPL % 2 == 0, "ds");
  static_assert(kSub * DS <= kThreads, "a thread a (step, state) sum");
  extern __shared__ __align__(16) float smem[];
  float2* sv = reinterpret_cast<float2*>(smem + L::V);  // [kT][kCh] dt, dt x
  float* sx = smem + L::X;                              // [kT][kCh]
  float* sdy = smem + L::DY;                            // [kT][kCh]
  float* sb = smem + L::B;                              // [kT][DS]
  float* sc = smem + L::C;                              // [kT][DS]
  float* sck = smem + L::CK;   // [kNSub][kThreads][SPL], each thread its own
  float* srb = smem + L::RB;   // [kSub][RED] g dt x by (channel, state)
  float* src = smem + L::RC;   // [kSub][RED] dy h
  float* sdx = smem + L::DX;   // [kT][kCh]
  float* sddt = smem + L::DDT; // [kT][kCh]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  // compute: channel ch, lane q holding states q*SPL .. q*SPL + SPL - 1
  const int ch = tid / kLanes, q = tid % kLanes;
  const bool live = d0 + ch < DI;
  // loads and stores: column lc, rows lr, lr + kRowsPerPass, ...
  const int lc = tid % kChannels, lr = tid / kChannels;
  const bool lcol = d0 + lc < DI;

  float a[SPL], g[SPL], dacc[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    a[j] = live ? A[(long long)(d0 + ch) * DS + q * SPL + j] : 0.f;
    g[j] = dacc[j] = 0.f;
  }
  const float dch = live ? Dv[d0 + ch] : 0.f;
  float dd_acc = 0.f;  // lane 0 of the channel: its part of dD
  float* ck = sck + tid * SPL;
  const T zero = from_f32<T>(0.f);

  const int n_tiles = (S + kT - 1) / kT;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kT;
    __syncthreads();  // the last tile's readers of the shared tiles are done
#pragma unroll 4
    for (int k = 0; k < XPT; ++k) {
      const int r = lr + kRowsPerPass * k, t = t0 + r;
      const bool ok = lcol && t < S;
      const long long d = d0 + lc;
      const float xv = to_f32(ok ? x[b * xs.b + t * xs.s + d] : zero);
      const float dv = to_f32(ok ? dt[b * dts.b + t * dts.s + d] : zero);
      const float yv = to_f32(ok ? dy[b * dys.b + t * dys.s + d] : zero);
      sv[r * kChannels + lc] = make_float2(dv, dv * xv);
      sx[r * kChannels + lc] = xv;
      sdy[r * kChannels + lc] = yv;
    }
    for (int i = tid; i < kT * DS; i += kThreads) {
      const int r = i / DS, n = i % DS, t = t0 + r;
      const bool ok = t < S;
      sb[i] = ok ? to_f32(bm[b * bs.b + t * bs.s + n]) : 0.f;
      sc[i] = ok ? to_f32(cm[b * cs.b + t * cs.s + n]) : 0.f;
    }
    float h[SPL];
    {
      const float* in = states +
                        (((long long)b * n_tiles + tile) * DI + d0 + ch) *
                            DS + q * SPL;
#pragma unroll
      for (int j = 0; j < SPL; ++j) h[j] = live ? in[j] : 0.f;
    }
    __syncthreads();

    // first pass: the state entering each sub-tile
#pragma unroll 1
    for (int sub = 0; sub < kNSub; ++sub) {
      sts(ck + sub * kThreads * SPL, h);
      if (sub + 1 == kNSub) break;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int r = sub * kSub + u;
        const float2 v = sv[r * kChannels + ch];
        float bv[SPL];
        lds(bv, &sb[r * DS + q * SPL]);
#pragma unroll
        for (int j = 0; j < SPL; ++j)
          h[j] = fmaf(expf(v.x * a[j]), h[j], v.y * bv[j]);
      }
    }

#pragma unroll 1
    for (int sub = kNSub - 1; sub >= 0; --sub) {
      // the sub-tile again, each step's decay and entering state kept
      float da[kSub][SPL], hp[kSub][SPL];
      lds(h, ck + sub * kThreads * SPL);
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int r = sub * kSub + u;
        const float2 v = sv[r * kChannels + ch];
        const float yv = sdy[r * kChannels + ch];
        float bv[SPL], hy[SPL];
        lds(bv, &sb[r * DS + q * SPL]);
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          da[u][j] = expf(v.x * a[j]);
          hp[u][j] = h[j];
          h[j] = fmaf(da[u][j], h[j], v.y * bv[j]);
          hy[j] = h[j] * yv;
        }
        sts(&src[u * L::RED + ch * DS + q * SPL], hy);
      }
      // walked back: g_t = C_t dy_t + a_{t+1} g_{t+1}
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int r = sub * kSub + u;
        const float2 v = sv[r * kChannels + ch];
        const float yv = sdy[r * kChannels + ch];
        float bv[SPL], cv[SPL], gx[SPL];
        lds(bv, &sb[r * DS + q * SPL]);
        lds(cv, &sc[r * DS + q * SPL]);
        float gb = 0.f, gah = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          g[j] = fmaf(cv[j], yv, g[j]);
          gb = fmaf(g[j], bv[j], gb);
          const float m = g[j] * da[u][j] * hp[u][j];  // g a h_{t-1}
          gah = fmaf(a[j], m, gah);
          dacc[j] = fmaf(v.x, m, dacc[j]);
          gx[j] = g[j] * v.y;
          g[j] *= da[u][j];
        }
        sts(&srb[u * L::RED + ch * DS + q * SPL], gx);
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          gb += __shfl_xor_sync(0xffffffffu, gb, off);
          gah += __shfl_xor_sync(0xffffffffu, gah, off);
        }
        if (q == 0) {
          const float xv = sx[r * kChannels + ch];
          sdx[r * kChannels + ch] = fmaf(v.x, gb, dch * yv);
          sddt[r * kChannels + ch] = fmaf(xv, gb, gah);
          dd_acc = fmaf(yv, xv, dd_acc);
        }
      }
      __syncthreads();
      if (tid < kSub * DS) {  // the CTA's sums over its channels
        const int u = tid / DS, n = tid % DS, t = t0 + sub * kSub + u;
        float sb_ = 0.f, sc_ = 0.f;
#pragma unroll 8
        for (int c = 0; c < kChannels; ++c) {
          sb_ += srb[u * L::RED + c * DS + n];
          sc_ += src[u * L::RED + c * DS + n];
        }
        if (t < S) {
          atomicAdd(dbm + ((long long)b * S + t) * DS + n, sb_);
          atomicAdd(dcm + ((long long)b * S + t) * DS + n, sc_);
        }
      }
      __syncthreads();  // the staged sums are read before the next sub-tile
    }
#pragma unroll 4
    for (int k = 0; k < XPT; ++k) {
      const int r = lr + kRowsPerPass * k, t = t0 + r;
      if (lcol && t < S) {
        const long long o = ((long long)b * S + t) * DI + d0 + lc;
        dx[o] = from_f32<T>(sdx[r * kChannels + lc]);
        ddt[o] = from_f32<T>(sddt[r * kChannels + lc]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      atomicAdd(dA + (long long)(d0 + ch) * DS + q * SPL + j, dacc[j]);
    if (q == 0) atomicAdd(dD + d0 + ch, dd_acc);
  }
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
  const void *x, *dt, *bm, *cm;
  const float *A, *D;
  const void* dy;
  const float* states;
  void *dx, *ddt;
  float *dbm, *dcm, *dA, *dD;
  int B, S, DI;
  Strides xs, dts, bs, cs, dys;
  cudaStream_t stream;
};

template <typename T, int DS>
cudaError_t launch(const Args& p) {
  static bool ready[64] = {false};
  constexpr int bytes = Smem<DS>::BYTES;
  cudaError_t err = allow_smem(scan_bwd<T, DS>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.DI + kChannels - 1) / kChannels, p.B);
  scan_bwd<T, DS><<<grid, kThreads, bytes, p.stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.dt),
      static_cast<const T*>(p.bm), static_cast<const T*>(p.cm), p.A, p.D,
      static_cast<const T*>(p.dy), p.states, static_cast<T*>(p.dx),
      static_cast<T*>(p.ddt), p.dbm, p.dcm, p.dA, p.dD, p.S, p.DI, p.xs,
      p.dts, p.bs, p.cs, p.dys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_state(const Args& p, int DS) {
  if (DS == 8) return launch<T, 8>(p);
  if (DS == 16) return launch<T, 16>(p);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of x, dt, B, C, dy, dx and ddt): 0 float32, 1 bfloat16. Strides
// are in elements, batch then sequence; each last dimension is contiguous.
// A is a contiguous (DI, DS) and D a (DI,) float32 tensor; states the
// forward's contiguous (B, ceil(S / 64), DI, DS) float32 tensor; dx and
// ddt are contiguous (B, S, DI) tensors; dbm and dcm contiguous (B, S, DS),
// dA (DI, DS) and dD (DI,) float32 tensors that the kernel adds into, so
// they must hold zeros. Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a state size or type the library was not
// built for.
int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* A, const void* D, const void* dy, const void* states,
    void* dx, void* ddt, void* dbm, void* dcm, void* dA, void* dD, int B,
    int S, int DI, int DS, int dtype, long long x_sb, long long x_ss,
    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    void* stream) {
  const Args p{x, dt, bm, cm, static_cast<const float*>(A),
               static_cast<const float*>(D), dy,
               static_cast<const float*>(states), dx, ddt,
               static_cast<float*>(dbm), static_cast<float*>(dcm),
               static_cast<float*>(dA), static_cast<float*>(dD), B, S, DI,
               Strides{x_sb, x_ss}, Strides{dt_sb, dt_ss},
               Strides{b_sb, b_ss}, Strides{c_sb, c_ss},
               Strides{dy_sb, dy_ss}, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_state<float>(p, DS);
  if (dtype == 1) return by_state<__nv_bfloat16>(p, DS);
  return cudaErrorInvalidValue;
}

}  // extern "C"
