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
// f32). All arithmetic is f32. The decay is the forward's (CheapDecay<T>):
// on the bf16 route ex2.approx of dt (A log2 e) with A log2 e as a hi + lo
// pair, so that the recompute retraces, bit for bit, the states the bf16
// forward wrote; the f32 route keeps expf.
//
// Bound on an H100 SXM at falcon-mamba-7b's train step, B = 4, S = 4096,
// di = 8192, ds = 16, bf16: the least work is one exponential per
// state-step, B S di ds = 2,147,483,648 of them; the special-function
// units return 16 a clock per SM (CUDA C++ Programming Guide, arithmetic
// throughput, compute capability 9.0), so 132 SMs at 1,980 MHz need
// 0.5136 ms. The function reads x, dt and dy and writes dx and ddt
// (5 x 268,435,456 bytes) and reads B, C, A, D and writes dB and dC
// (about 2.2 MB): 1.34 GB, 0.4014 ms at 3.35 TB/s. The exponentials bound
// it; in practice the float32 work around them does (about 0.064 ms for
// each instruction a state-step at one warp instruction a clock on each
// of the 528 schedulers).
//
// Design (scan_bwd_cluster), the times measured on an H100 at that shape
// (PERF.md): CTAs of kThreads = 256 threads, kChannels = 64
// channels each, each channel's ds states split over kLanes = 4
// neighbouring lanes (the forward's lanes), grid (di / 64 rounded up to
// whole clusters, B), clusters of kCluster = 2 CTAs along di. Time runs in
// the forward's tiles of kT = 64 steps, last tile first, g carried in
// registers. A tile is recomputed from its entering state in two levels:
// a first pass runs steps 0..55 and keeps the state at the 8-step
// boundaries 1..6 in shared memory (each thread its own) and boundary 7 in
// registers; then, sub-tile by sub-tile from the last, the 8 steps are run
// again with each step's decay and entering state kept in registers, and
// walked back. So a state-step costs two exponentials (the MUFU floor
// 1.03 ms, below what the schedulers dispatch). What set the time, and
// what the design does about it:
//   - Shared-memory traffic, then instruction count. x, dt and dy are
//     staged in their own type and widened in registers (a shift each);
//     B and C are widened to f32 once a tile (read 4 times a step in
//     all). 128-bit loads of f32 staging and channel sums through a
//     shared-memory scratch made an earlier version of this design
//     slower than the kernel it replaces (scan_bwd: 128-thread CTAs, two
//     expf a state-step, dB and dC by atomics).
//   - Occupancy: about 99 KB of shared memory a CTA at ds 16 in bf16 and
//     128 registers a thread, no spills: two CTAs, 16 warps, an SM. Rows
//     of x, dt and dy are padded by 16 bytes so that a channel's 4 lanes
//     reading 4 steps at once hit 4 bank groups.
//   - Loads: each 16-byte chunk of the tile before is fetched by cp.async
//     into the rows the walk-back has just freed, by the thread that
//     first stores that chunk's dx or ddt (which the walk-back wrote over
//     x and dy); a spare block takes the tile before's first 8 rows at the
//     start of a tile, so no wait is exposed. The state entering a tile
//     and sub-tile 0 come by cp.async into checkpoint slots already read.
//     The wrapper copies an input whose rows do not start on 16-byte
//     chunks (no copy on falcon-mamba-7b's path).
//   - Barriers: one a sub-tile and two a tile (10 a tile), and one cluster
//     barrier phase each way a tile, half a tile apart.
//   - dx and ddt: each channel's 4 lanes sum g B and A g a h over their
//     states for 4 steps at a time and reduce-scatter the sums by
//     shuffles (lane q ends with step q), which then writes dx and ddt.
//   - dB and dC: g dt x (and, in the forward sub-pass, dy h) of 32 / ds
//     steps summed over the warp's 8 channels by shuffles, reduce-
//     scattered (a lane an output); after the sub-tile's barrier the CTA
//     sums its 8 warps in order into the tile's sums; half a tile later
//     each rank of the cluster sums its half of the tile's steps over the
//     2 CTAs through distributed shared memory and stores it into a
//     per-cluster f32 part (B, ceil(di / 128), S, ds), which the wrapper
//     sums in order. No atomics and no global adds: a run gives the same
//     bits every time. Clusters of 4 (256 channels a part) read about 1 ms
//     slower at the step shape (fewer CTAs resident), so 2 were kept.
//   - dA and dD: per batch element, into f32 parts (B, di, ds) and (B, di)
//     that the wrapper sums.
// Steps past S load as zeros (dt = 0: no decay, no input, no gradient) and
// are not stored; channels past di are masked (the CTAs of a cluster past
// di run on zeros, for the cluster's barriers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                      // lanes a channel
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;                  // CTAs an SM: 128 registers
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = kThreads / kLanes;   // channels a CTA
constexpr int kCluster = 2;                    // CTAs a cluster, along di
constexpr int kT = 64;                         // the forward's tile
constexpr int kSub = 8;                        // steps a sub-tile
constexpr int kNSub = kT / kSub;
constexpr int kSlots = kNSub - 2;              // checkpoints in shared memory
constexpr int kSpan = kT / kCluster;           // a rank's steps of a tile
constexpr double kLog2e = 1.4426950408889634;
static_assert(kT % kCluster == 0 && kLanes == 4, "tiles, lanes");

struct Strides {
  long long b, s;
};

// Which decay a route takes: ex2.approx of the hi + lo argument (true) or
// the accurate expf (false), as the forward kernel's
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
// a where the mask m is all ones, b where it is zero: one LOP3 (the
// compiler swaps a conditional pair with three moves otherwise)
__device__ __forceinline__ float pick(uint32_t m, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & m) |
                         (__float_as_uint(b) & ~m));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// BYTES (4, 8 or 16) of global memory into shared memory, asynchronously:
// the first `n` bytes read, the rest zeros (nothing is read for n = 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ... all but the newest group
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// two floats at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float2 ld_cluster(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

template <typename T, int DS>
struct Smem {
  static constexpr int SPL = DS / kLanes;
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  // a staged row of x, dt or dy, padded so that 4 rows (a channel's 4
  // lanes at once) fall on other banks
  static constexpr int ROW = kChannels + VEC;
  static constexpr int ROWS = kT + kSub;  // a tile and a spare sub-tile
  // bytes: x, dt, dy [ROWS][ROW] and B, C [ROWS][DS], in T, as staged;
  // B and C widened [kT][DS]; checkpoints [kSlots][kThreads][SPL]; the
  // warps' dB, dC sums [2 buffers][kWarps][2][kSub][DS]; the tile's [2
  // buffers][2][kT][DS]; all f32
  static constexpr int X = 0, DT = X + ROWS * ROW * (int)sizeof(T),
                       DY = DT + ROWS * ROW * (int)sizeof(T),
                       B = DY + ROWS * ROW * (int)sizeof(T),
                       C = B + ROWS * DS * (int)sizeof(T),
                       BF = C + ROWS * DS * (int)sizeof(T),
                       CF = BF + kT * DS * 4, CK = CF + kT * DS * 4,
                       W = CK + kSlots * kThreads * SPL * 4,
                       E = W + 2 * kWarps * 2 * kSub * DS * 4,
                       BYTES = E + 2 * 2 * kT * DS * 4;
};

template <typename T, int DS>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ A, const float* __restrict__ Dv,
                 const T* __restrict__ dy, const float* __restrict__ states,
                 T* __restrict__ dx, T* __restrict__ ddt,
                 float* __restrict__ dbp, float* __restrict__ dcp,
                 float* __restrict__ dap, float* __restrict__ ddp, int S,
                 int DI, int DOUT, Strides xs, Strides dts, Strides bs,
                 Strides cs, Strides dys) {
  using L = Smem<T, DS>;
  constexpr int SPL = L::SPL;                     // states a lane
  constexpr int VEC = L::VEC, ROW = L::ROW;
  constexpr int BATCH = 8 / SPL;                  // steps a shuffle sum
  constexpr int CPR = kChannels / VEC;            // chunks a staged row
  constexpr int CPB = DS / VEC;                   // chunks a row of B
  constexpr int NX = kSub * CPR, NB = kSub * CPB; // chunks a sub-tile
  constexpr bool kCheap = CheapDecay<T>::value;
  // gah sums hi m: A log2 e on the cheap route
  constexpr float kGah = kCheap ? 0.6931471805599453f : 1.f;
  static_assert(DS % kLanes == 0 && SPL % 2 == 0 && DS % VEC == 0, "ds");
  static_assert(BATCH * SPL == 8 && 4 % BATCH == 0, "8 values a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem + L::X);
  T* sdt = reinterpret_cast<T*>(smem + L::DT);
  T* sdy = reinterpret_cast<T*>(smem + L::DY);
  T* sb = reinterpret_cast<T*>(smem + L::B);
  T* sc = reinterpret_cast<T*>(smem + L::C);
  float* sbf = reinterpret_cast<float*>(smem + L::BF);
  float* scf = reinterpret_cast<float*>(smem + L::CF);
  float* sck = reinterpret_cast<float*>(smem + L::CK);
  float* sw = reinterpret_cast<float*>(smem + L::W);
  float* se = reinterpret_cast<float*>(smem + L::E);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  // channel ch (the warp's cw-th), lane q holding states q*SPL .. +SPL-1
  const int ch = tid / kLanes, q = tid % kLanes, cw = lane / kLanes;
  const bool live = d0 + ch < DI;
  const int n_tiles = (S + kT - 1) / kT;
  const uint32_t rank = cluster_rank();
  const int cl = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  float* ckp = sck + tid * SPL;  // this thread's, kThreads * SPL apart

  float hi[SPL], lo[SPL], g[SPL], dacc[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const float aj = live ? A[(long long)(d0 + ch) * DS + q * SPL + j] : 0.f;
    if constexpr (kCheap) {
      const double a2 = (double)aj * kLog2e;  // A log2 e, hi + lo
      hi[j] = (float)a2;
      lo[j] = (float)(a2 - (double)hi[j]);
    } else {
      hi[j] = aj;
      lo[j] = 0.f;
    }
    g[j] = dacc[j] = 0.f;
  }
  const float dch = live ? Dv[d0 + ch] : 0.f;
  float dd_acc = 0.f;  // this lane's steps' part of dD

  auto decay = [&](float dtv, int j) {
    if constexpr (kCheap)
      return ex2(fmaf(dtv, hi[j], dtv * lo[j]));
    else
      return expf(dtv * hi[j]);
  };
  // the state entering `tile`, into checkpoint slot `slot`
  auto fetch_state = [&](int slot, int tile) {
    const float* src = states + (((long long)b * n_tiles + tile) * DI + d0 +
                                 ch) * DS + q * SPL;
    cp_async<SPL * 4>(ckp + slot * kThreads * SPL, live ? src : states,
                      live ? SPL * 4 : 0);
    cp_async_commit();
  };
  // 8 values v[k * SPL + j] (step k of a batch, state j of this lane)
  // summed over the warp's 8 channels by shuffles and reduce-scattered:
  // lane (cw, q) keeps value cw, which it stores into `out` ([step][DS])
  auto channel_sum = [&](float (&v)[8], float* out) {
#pragma unroll
    for (int half = 4; half >= 1; half /= 2) {
      const uint32_t upper = cw & half ? ~0u : 0u;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = pick(upper, v[i], v[i + half]);
        const float keep = pick(upper, v[i + half], v[i]);
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, half * kLanes);
      }
    }
    out[(cw / SPL) * DS + q * SPL + cw % SPL] = v[0];
  };
  // Rows of x, dt, dy, B and C are staged in 16-byte chunks by cp.async,
  // a chunk a work item: block `blk` (8 rows) of the tile at t0 from the
  // rows t0 + r0 .. of the input. With `out`, the block's dx and ddt
  // (which the walk-back wrote over x and dy) are first stored from the
  // chunks that the same item then overwrites. Chunks past S or di read
  // zeros.
  auto refill = [&](int blk, int t0, int r0, bool out, bool in, int tout) {
#pragma unroll 1
    for (int w = tid; w < 3 * NX + 2 * NB; w += kThreads) {
      if (w < 3 * NX) {
        const int a = w / NX, i = w % NX, r = i / CPR, c = (i % CPR) * VEC;
        T* slot = (a == 0 ? sx : a == 1 ? sdt : sdy) + (blk * kSub + r) * ROW
                  + c;
        const int nv = min(VEC, DI - d0 - c);  // channels below di
        if (out && a != 1 && nv > 0 && tout + r < S)
          *reinterpret_cast<uint4*>(
              (a == 0 ? dx : ddt) + ((long long)b * S + tout + r) * DOUT +
              d0 + c) = *reinterpret_cast<const uint4*>(slot);
        if (in) {
          const long long t = t0 + r0 + r;
          const bool ok = nv > 0 && t < S;
          const T* src = a == 0 ? x + b * xs.b + t * xs.s
                         : a == 1 ? dt + b * dts.b + t * dts.s
                                  : dy + b * dys.b + t * dys.s;
          cp_async<16>(slot, ok ? src + d0 + c : x, ok ? nv * (int)sizeof(T)
                                                      : 0);
        }
      } else if (in) {
        const int i = w - 3 * NX, ab = i / NB, r = (i % NB) / CPB,
                  c = (i % CPB) * VEC;
        const long long t = t0 + r0 + r;
        const T* src = ab ? cm + b * cs.b + t * cs.s : bm + b * bs.b +
                                                          t * bs.s;
        cp_async<16>((ab ? sc : sb) + (blk * kSub + r) * DS + c,
                     t < S ? src + c : x, t < S ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // a tile's dB and dC sums over the cluster: this rank's kSpan steps,
  // the ranks in order, into the cluster's part
  auto exchange = [&](int tile) {
    const int t0 = tile * kT;
    const float* et = se + (tile & 1) * 2 * kT * DS;
#pragma unroll 1
    for (int o = tid; o < kSpan * DS; o += kThreads) {
      const int kind = o / (kSpan * DS / 2), e = 2 * (o % (kSpan * DS / 2));
      const float* p = et + kind * kT * DS + rank * kSpan * DS + e;
      float2 sum = make_float2(0.f, 0.f);
      for (int r = 0; r < kCluster; ++r) {
        const float2 v = ld_cluster(p, r);
        sum.x += v.x;
        sum.y += v.y;
      }
      const int t = t0 + rank * kSpan + e / DS;
      if (t < S)
        *reinterpret_cast<float2*>(
            (kind ? dcp : dbp) +
            (((long long)b * n_cl + cl) * S + t) * DS + e % DS) = sum;
    }
  };

  // the last tile, staged whole (its sub-tile 0 in the spare block of an
  // odd tile), and its entering state
  fetch_state(1, n_tiles - 1);
  for (int blk = 0; blk < kNSub; ++blk)
    refill(blk == 0 && ((n_tiles - 1) & 1) ? kNSub : blk,
           (n_tiles - 1) * kT, blk * kSub, false, true, 0);

  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kT;
    const int blk0 = (tile & 1) ? kNSub : 0;  // where sub-tile 0 lives
    cp_async_wait();
    __syncthreads();  // the tile's rows are staged
    // B and C widened to f32 once (their 4 states a lane are read 4 times
    // a step in all)
#pragma unroll 1
    for (int i = tid; i < 2 * kT * DS / 4; i += kThreads) {
      const int e = 4 * (i % (kT * DS / 4)), r = e / DS;
      const T* src = (i < kT * DS / 4 ? sb : sc) +
                     ((r < kSub ? blk0 : r / kSub) * kSub + r % kSub) * DS +
                     e % DS;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = to_f32(src[k]);
      sts(&(i < kT * DS / 4 ? sbf : scf)[e], v);
    }
    __syncthreads();
    // the tile before's sub-tile 0, into the other block
    if (tile > 0) refill(kNSub - blk0, t0 - kT, 0, false, true, 0);
    float h[SPL];
    lds(h, ckp + kThreads * SPL);

    // first pass: the state at each sub-tile boundary
#pragma unroll 1
    for (int sub = 0; sub + 1 < kNSub; ++sub) {
      const int rb = (sub ? sub : blk0) * kSub;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int r = rb + u;
        const float dtv = to_f32(sdt[r * ROW + ch]);
        const float dtx = dtv * to_f32(sx[r * ROW + ch]);
        float bv[SPL];
        lds(bv, &sbf[(sub * kSub + u) * DS + q * SPL]);
#pragma unroll
        for (int j = 0; j < SPL; ++j)
          h[j] = fmaf(decay(dtv, j), h[j], dtx * bv[j]);
      }
      if (sub < kSlots) sts(ckp + sub * kThreads * SPL, h);
    }
#pragma unroll 1
    for (int s = kNSub - 1; s >= 0; --s) {
      if (s < kNSub - 1) {  // boundary s: slot s - 1; boundary 0: slot 0
        if (s == 0) cp_async_wait_older();  // slot 0, not the last refill
        lds(h, ckp + (s > 0 ? s - 1 : 0) * kThreads * SPL);
      }
      const int rb = (s ? s : blk0) * kSub;
      float* wp = sw + ((s & 1) * kWarps + warp) * 2 * kSub * DS;
      // the sub-tile again, each step's decay and entering state kept;
      // dy h summed over the warp's channels
      float da[kSub][SPL], hp[kSub][SPL];
#pragma unroll
      for (int ub = 0; ub < kSub; ub += BATCH) {
        float hy[8];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const int u = ub + k, r = rb + u;
          const float dtv = to_f32(sdt[r * ROW + ch]);
          const float dtx = dtv * to_f32(sx[r * ROW + ch]);
          const float yv = to_f32(sdy[r * ROW + ch]);
          float bv[SPL];
          lds(bv, &sbf[(s * kSub + u) * DS + q * SPL]);
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            da[u][j] = decay(dtv, j);
            hp[u][j] = h[j];
            h[j] = fmaf(da[u][j], h[j], dtx * bv[j]);
            hy[k * SPL + j] = h[j] * yv;
          }
        }
        channel_sum(hy, wp + (kSub + ub) * DS);
      }
      // the slot just read takes the state the tile before enters with
      // (after sub-tile 2) and this tile's (after sub-tile 1, for 0)
      if (s == 2 && tile > 0) fetch_state(1, tile - 1);
      if (s == 1) fetch_state(0, tile);

      // walked back, 4 steps a group: g_t = C_t dy_t + a_{t+1} g_{t+1}
#pragma unroll
      for (int grp = kSub / 4 - 1; grp >= 0; --grp) {
        float part[8];  // g B and A g a h of the group's steps
#pragma unroll
        for (int kb = 4 / BATCH - 1; kb >= 0; --kb) {
          float gx[8];
#pragma unroll
          for (int k = BATCH - 1; k >= 0; --k) {
            const int w4 = kb * BATCH + k, u = grp * 4 + w4, r = rb + u;
            const float dtv = to_f32(sdt[r * ROW + ch]);
            const float dtx = dtv * to_f32(sx[r * ROW + ch]);
            const float yv = to_f32(sdy[r * ROW + ch]);
            float bv[SPL], cv[SPL];
            lds(bv, &sbf[(s * kSub + u) * DS + q * SPL]);
            lds(cv, &scf[(s * kSub + u) * DS + q * SPL]);
            float gb = 0.f, gah = 0.f;
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              g[j] = fmaf(cv[j], yv, g[j]);
              gb = fmaf(g[j], bv[j], gb);
              gx[k * SPL + j] = g[j] * dtx;
              const float ga = g[j] * da[u][j];
              const float m = ga * hp[u][j];  // g a h_{t-1}
              gah = fmaf(hi[j], m, gah);
              dacc[j] = fmaf(dtv, m, dacc[j]);
              g[j] = ga;
            }
            part[2 * w4] = gb;
            part[2 * w4 + 1] = gah;
          }
          channel_sum(gx, wp + (grp * 4 + kb * BATCH) * DS);
        }
        // reduce-scattered over the channel's lanes: lane q, step q
#pragma unroll
        for (int half = 2; half >= 1; half /= 2) {
          const uint32_t upper = q & half ? ~0u : 0u;
#pragma unroll
          for (int i = 0; i < 2 * half; ++i) {
            const float send = pick(upper, part[i], part[i + 2 * half]);
            const float keep = pick(upper, part[i + 2 * half], part[i]);
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
          }
        }
        const int r = rb + grp * 4 + q;
        const float dtv = to_f32(sdt[r * ROW + ch]);
        const float xv = to_f32(sx[r * ROW + ch]);
        const float yv = to_f32(sdy[r * ROW + ch]);
        dd_acc = fmaf(yv, xv, dd_acc);
        sx[r * ROW + ch] = from_f32<T>(fmaf(dtv, part[0], dch * yv));
        sdy[r * ROW + ch] = from_f32<T>(fmaf(xv, part[0], kGah * part[1]));
      }
      cp_async_wait();
      __syncthreads();  // the warps' sums are in; the sub-tile's rows free

      // the warps' sums into the tile's
      const float* wsum = sw + (s & 1) * kWarps * 2 * kSub * DS;
      float* et = se + (tile & 1) * 2 * kT * DS;
#pragma unroll 1
      for (int o = tid; o < 2 * kSub * DS; o += kThreads) {
        float sum = wsum[o];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += wsum[w * 2 * kSub * DS + o];
        const int kind = o / (kSub * DS);
        et[kind * kT * DS + s * kSub * DS + o % (kSub * DS)] = sum;
      }
      // half a tile after the ranks arrived with the tile after's sums,
      // they are summed over the cluster
      if (s == kNSub / 2 && tile + 1 < n_tiles) {
        cluster_wait();
        exchange(tile + 1);
        cluster_arrive();
      }
      // dx and ddt out; the tile before's rows in (its sub-tile 0 came
      // at the start of this tile)
      refill(rb / kSub, t0 - kT, s * kSub, true, tile > 0 && s > 0,
             t0 + s * kSub);
    }
    // the ranks have read the tile after's sums (their buffer takes the
    // tile before's), and this tile's are in
    if (tile + 1 < n_tiles) cluster_wait();
    cluster_arrive();
  }
  cluster_wait();
  exchange(0);
  cluster_arrive();
  cluster_wait();  // no CTA leaves while another reads its sums

  if (live) {
    float* out = dap + ((long long)b * DI + d0 + ch) * DS + q * SPL;
#pragma unroll
    for (int j = 0; j < SPL; ++j) out[j] = dacc[j];
  }
  dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, 1);
  dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, 2);
  if (live && q == 0) ddp[(long long)b * DI + d0 + ch] = dd_acc;
}

struct Args {
  const void *x, *dt, *bm, *cm;
  const float *A, *D;
  const void* dy;
  const float* states;
  void *dx, *ddt;
  float *dbp, *dcp, *dap, *ddp;
  int B, S, DI, DOUT;
  Strides xs, dts, bs, cs, dys;
  cudaStream_t stream;
};

template <typename T, int DS>
cudaError_t launch(const Args& p) {
  static bool ready[64] = {false};  // the attributes, set once per device
  constexpr int bytes = Smem<T, DS>::BYTES;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(scan_bwd_cluster<T, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          scan_bwd_cluster<T, DS>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  const int n_cl = (p.DI + kChannels * kCluster - 1) / (kChannels * kCluster);
  const dim3 grid(n_cl * kCluster, p.B);
  scan_bwd_cluster<T, DS><<<grid, kThreads, bytes, p.stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.dt),
      static_cast<const T*>(p.bm), static_cast<const T*>(p.cm), p.A, p.D,
      static_cast<const T*>(p.dy), p.states, static_cast<T*>(p.dx),
      static_cast<T*>(p.ddt), p.dbp, p.dcp, p.dap, p.ddp, p.S, p.DI, p.DOUT,
      p.xs, p.dts, p.bs, p.cs, p.dys);
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

// The channels one part of dB and dC sums (a cluster's).
int selective_scan_bwd_part_channels(void) { return kChannels * kCluster; }

// dtype (of x, dt, B, C, dy, dx and ddt): 0 float32, 1 bfloat16. Strides
// are in elements, batch then sequence; each last dimension is contiguous;
// x, dt, dy, B and C start 16-byte aligned and their strides are whole
// 16-byte chunks. A is a contiguous (DI, DS) and D a (DI,) float32 tensor;
// states the forward's contiguous (B, ceil(S / 64), DI, DS) float32
// tensor; dx and ddt are (B, S, DOUT) tensors, DOUT >= DI rounded up to whole
// 16-byte chunks, of which the kernel writes the first DI columns (and
// zeros or other values into the rest). The kernel writes, and does not
// add into: dbp and dcp, contiguous (B, P, S, DS) float32 tensors with P =
// ceil(DI / selective_scan_bwd_part_channels()), dB and dC summed over each
// part's channels; dap (B, DI, DS) and ddp (B, DI), dA and dD of each batch
// element. Returns a CUDA error code (0 on success); cudaErrorInvalidValue
// for a state size or type the library was not built for.
int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* A, const void* D, const void* dy, const void* states,
    void* dx, void* ddt, void* dbp, void* dcp, void* dap, void* ddp, int B,
    int S, int DI, int DOUT, int DS, int dtype, long long x_sb, long long x_ss,
    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    void* stream) {
  const Args p{x, dt, bm, cm, static_cast<const float*>(A),
               static_cast<const float*>(D), dy,
               static_cast<const float*>(states), dx, ddt,
               static_cast<float*>(dbp), static_cast<float*>(dcp),
               static_cast<float*>(dap), static_cast<float*>(ddp), B, S, DI,
               DOUT, Strides{x_sb, x_ss}, Strides{dt_sb, dt_ss},
               Strides{b_sb, b_ss}, Strides{c_sb, c_ss},
               Strides{dy_sb, dy_ss}, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_state<float>(p, DS);
  if (dtype == 1) return by_state<__nv_bfloat16>(p, DS);
  return cudaErrorInvalidValue;
}

}  // extern "C"
