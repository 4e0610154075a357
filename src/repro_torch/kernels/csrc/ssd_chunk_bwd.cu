// The gradient of the Mamba2 / SSD chunked scan (csrc/ssd_chunk.cu) for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its pure-jnp
// chunked SSD (src/repro/models/mamba.py:161-210) with jax.grad, and the
// Pallas ssd_chunk (src/repro/kernels/ssd_chunk.py) has no backward. With
// a_t = exp(dt_t A), the state h_t = a_t h_{t-1} + dt_t B_t (x) x_t of
// (ds, hd) a head, y_t = C_t . h_t and g_t = C_t (x) dy_t + a_{t+1} g_{t+1}
// (the loss's gradient with respect to h_t), it computes
//     dx_t  = dt_t B_t^T g_t                      (B, S, nh, hd), x's type
//     dB_t  = sum_h dt_t g_t x_t                  (B, S, ds), f32 sums
//     dC_t  = sum_h h_t dy_t                      (B, S, ds), f32 sums
//     ddt_t = <g_t, A a_t h_{t-1} + B_t (x) x_t>  (B, S, nh), f32
//     dA    = sum_{b,t} dt_t a_t <g_t, h_{t-1}>   (nh,), f32
// from x, B, C (x's type, read through their strides), dt and A (f32),
// dy, and the state entering each 64-step chunk, which the forward kernel
// writes under grad ((B, n_chunks, nh, ds, hd) f32).
//
// Chunk form. Within a chunk of Q = 64 steps with l the inclusive
// cumulative sum of dt A, lend its last value, h0 the entering state and
// K the gradient with respect to the chunk's last state from the later
// chunks (zero for the last chunk), g_t = sum_{r>=t} e^(l_r - l_t) C_r (x)
// dy_r + e^(lend - l_t) K. With the chunk's (Q, Q) matrices
//     Dm[r][s] = (C_r . B_s) e^(l_r - l_s),   E[r][s] = (dy_r . x_s)
//     e^(l_r - l_s)   for s <= r (0 above the diagonal),
//     W[r][s]  = Dm[r][s] dt_s (dy_r . x_s),
// each gradient is a sum of products:
//     z    = Dm^T dy + e^(lend - l) (B K),      dx = dt z
//     dC   = (E dt) B + e^l (dy h0^T)
//     dB   = dt (E^T C + e^(lend - l) (x K^T))
//     K   <- e^lend K + (e^l C)^T dy            (for the chunk before)
// and the decay terms read m_t = <g_t, a_t h_{t-1}>, in which l_t cancels:
//     m_t = sum_{s<t<=r} W[r][s] + sum_{r>=t} u_r + sum_{s<t} v_s + c,
//     u_r = e^(l_r) C_r . (h0 dy_r),  v_s = e^(lend - l_s) dt_s B_s . (K
//     x_s),  c = e^lend <K, h0>;
// the first sum is a running sum of W's column sums less its row sums,
// both without the diagonal, so no term of m is the difference of two
// that hold the step's own input (m_t = q_t - dt_t x_t . z_t, with q_t =
// <g_t, h_t>, cancels where a_t h_{t-1} is small beside dt_t B_t (x) x_t,
// and put the kernel's f32 dA several times further from the plain
// version's). Then ddt_t = A m_t + x_t . z_t and dA sums dt_t m_t.
// Nothing finer than a chunk is stored: each chunk is recomputed from h0.
//
// Design (the first, simple kernel; a Hopper redesign is later work): one
// CTA of 256 threads a (batch, head), grid (nh, B), walking the chunks in
// reverse with K in shared memory. Each chunk's x, dy, B, C (as f32), dt
// and h0 are staged in shared memory; each thread computes 4 x 4 blocks
// of the (Q, Q) matrices and 4 x (cols / 16) blocks of the products with
// scalar f32 FMAs, rows padded by one float (conflict-free). dB and dC sum
// over the nh heads, which are other CTAs: each CTA adds its chunk's rows
// into f32 buffers with atomicAdd (red.global.add.f32), so the order of
// the nh additions changes from run to run (about 1e-7 relative in f32);
// dA adds one value a CTA. Rows past S load as zeros (dt = 0: no decay,
// no input, no gradient) and are not stored; S < 64 is one ragged chunk.
//
// Bound on an H100 SXM at zamba2-1.2b's train step, B = 4, S = 4096,
// nh = 64, hd = 64, ds = 64, bf16: the function reads x and dy
// (2 x 134,217,728 bytes), B and C (2 x 2,097,152), dt (4,194,304) and
// writes dx (134,217,728), dB and dC (2 x 2,097,152) and ddt (4,194,304):
// 419,430,400 bytes, 0.1252 ms at 3.35 TB/s. Its chunked arithmetic is
// nine (64 x 64 x 64) products a chunk and head (C B^T, dy x^T, Dm^T dy,
// B K, E dt B, dy h0^T, E^T C, x K^T, C^T dy), 4.7 MFLOP, 77.3 GFLOP over
// the 16,384 chunks and heads: 0.078 ms at the bf16 tensor-core rate. It
// is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // chunk length: the forward's

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
// the sum over the 16 neighbouring lanes that share a row group
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD, int DS>
struct Smem {
  static constexpr int LX = HD + 1;  // x, dy, h0 and K rows
  static constexpr int LB = DS + 1;  // B and C rows
  static constexpr int LQ = kQ + 1;  // Dm and E rows
  static constexpr int X = kQ * LX, BC = kQ * LB, H = DS * LX,
                       M = kQ * LQ;
  // x, dy; B, C; h0, K; Dm, E; dt, l, e^l, e^(lend - l), x.z, u, v, row
  // and column sums of W; lend, c
  static constexpr int FLOATS = 2 * X + 2 * BC + 2 * H + 2 * M + 9 * kQ + 2;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_bwd(const T* __restrict__ x, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ dy,
        const float* __restrict__ states, T* __restrict__ dx,
        float* __restrict__ dbm, float* __restrict__ dcm,
        float* __restrict__ ddt, float* __restrict__ dA, int S, int NH,
        Strides xs, Strides bs, Strides cs, Strides dts, Strides dys) {
  using L = Smem<HD, DS>;
  constexpr int CJ = HD / 16;  // hd columns a thread
  constexpr int RN = DS / 16;  // ds columns (or rows) a thread
  static_assert(HD % 16 == 0 && DS % 16 == 0, "tile sizes");
  extern __shared__ float smem[];
  float* sx = smem;            // [kQ][LX]
  float* sdy = sx + L::X;      // [kQ][LX]
  float* sb = sdy + L::X;      // [kQ][LB]
  float* sc = sb + L::BC;      // [kQ][LB]
  float* sh = sc + L::BC;      // [DS][LX] the chunk's entering state
  float* sk = sh + L::H;       // [DS][LX] K, carried from later chunks
  float* sd = sk + L::H;       // [kQ][LQ] Dm
  float* se = sd + L::M;       // [kQ][LQ] E
  float* sdt = se + L::M;      // [kQ]
  float* sl = sdt + kQ;        // [kQ] l
  float* sel = sl + kQ;        // [kQ] e^l
  float* sed = sel + kQ;       // [kQ] e^(lend - l)
  float* sxz = sed + kQ;       // [kQ] x . z
  float* su = sxz + kQ;        // [kQ] u
  float* sv = su + kQ;         // [kQ] v
  float* srs = sv + kQ;        // [kQ] W's row sums
  float* scs = srs + kQ;       // [kQ] W's column sums
  float* sscal = scs + kQ;     // [2] lend, c

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid >> 4, cg = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const int n_chunks = (S + kQ - 1) / kQ;
  const T* xb = x + b * xs.b + h * xs.h;
  const T* dyb = dy + b * dys.b + h * dys.h;
  const T* bb = bm + b * bs.b;
  const T* cb = cm + b * cs.b;
  const float* db = dt + b * dts.b + h * dts.h;
  T* dxb = dx + ((long long)b * S * NH + h) * HD;        // contiguous
  float* dbb = dbm + (long long)b * S * DS;               // contiguous
  float* dcb = dcm + (long long)b * S * DS;
  float* ddb = ddt + (long long)b * S * NH + h;
  float da_acc = 0.f;  // warp 0: this lane's part of dA

  for (int i = tid; i < L::H; i += kThreads) sk[i] = 0.f;

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kQ;
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < kQ * HD; i += kThreads) {
      const int r = i / HD, p = i % HD, t = t0 + r;
      const bool ok = t < S;
      sx[r * L::LX + p] = ok ? to_f32(xb[t * xs.s + p]) : 0.f;
      sdy[r * L::LX + p] = ok ? to_f32(dyb[t * dys.s + p]) : 0.f;
    }
    for (int i = tid; i < kQ * DS; i += kThreads) {
      const int r = i / DS, n = i % DS, t = t0 + r;
      const bool ok = t < S;
      sb[r * L::LB + n] = ok ? to_f32(bb[t * bs.s + n]) : 0.f;
      sc[r * L::LB + n] = ok ? to_f32(cb[t * cs.s + n]) : 0.f;
    }
    const float* h0 = states + (((long long)b * n_chunks + ch) * NH + h) *
                                   DS * HD;
    for (int i = tid; i < DS * HD; i += kThreads)
      sh[(i / HD) * L::LX + i % HD] = h0[i];
    if (tid < kQ) {
      sdt[tid] = t0 + tid < S ? db[(t0 + tid) * dts.s] : 0.f;
      srs[tid] = scs[tid] = 0.f;
    }
    if (tid == 0) sscal[1] = 0.f;
    __syncthreads();

    if (tid < 32) {  // one warp: l, two steps a lane
      const float a0 = sdt[2 * tid] * a, a1 = sdt[2 * tid + 1] * a;
      float v = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      float before = __shfl_up_sync(0xffffffffu, v, 1);
      if (tid == 0) before = 0.f;
      const float l0 = before + a0;
      const float lend = __shfl_sync(0xffffffffu, v, 31);
      sl[2 * tid] = l0;
      sl[2 * tid + 1] = v;
      sel[2 * tid] = expf(l0);
      sel[2 * tid + 1] = expf(v);
      sed[2 * tid] = expf(lend - l0);
      sed[2 * tid + 1] = expf(lend - v);
      if (tid == 0) sscal[0] = lend;
    }
    __syncthreads();

    {  // Dm, E, and W's row and column sums below the diagonal
      float gcb[4][4], gp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gcb[i][j] = gp[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(rg + 16 * i) * L::LB + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sb[(cg + 16 * j) * L::LB + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gcb[i][j] = fmaf(cv[i], bv[j], gcb[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < HD; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = sdy[(rg + 16 * i) * L::LX + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sx[(cg + 16 * j) * L::LX + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gp[i][j] = fmaf(dv[i], xv[j], gp[i][j]);
      }
      float cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        float row = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = cg + 16 * j;
          const float dec = s <= r ? expf(sl[r] - sl[s]) : 0.f;
          const float dm = gcb[i][j] * dec;
          const float w = dm * sdt[s] * gp[i][j];
          sd[r * L::LQ + s] = dm;
          se[r * L::LQ + s] = gp[i][j] * dec;
          if (s < r) {
            row += w;
            cols[j] += w;
          }
        }
        atomicAdd(&srs[r], row);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&scs[cg + 16 * j], cols[j]);
    }
    __syncthreads();

    {  // z = Dm^T dy + e^(lend - l) (B K); dx = dt z; x . z
      float acc[4][CJ], bk[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = bk[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kQ; ++r) {
        float dv[4], yv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = sd[r * L::LQ + rg + 16 * i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) yv[j] = sdy[r * L::LX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(dv[i], yv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float bv[4], kv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = sb[(rg + 16 * i) * L::LB + n];
#pragma unroll
        for (int j = 0; j < CJ; ++j) kv[j] = sk[n * L::LX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) bk[i][j] = fmaf(bv[i], kv[j], bk[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = rg + 16 * i, t = t0 + s;
        const float e = sed[s], d = sdt[s];
        float xz = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int p = cg + 16 * j;
          const float z = fmaf(e, bk[i][j], acc[i][j]);
          xz = fmaf(sx[s * L::LX + p], z, xz);
          if (t < S) store(dxb + (long long)t * NH * HD + p, d * z);
        }
        xz = sum16(xz);
        if (cg == 0) sxz[s] = xz;
      }
    }

    {  // dC = (E dt) B + e^l (dy h0^T); u = C . (e^l dy h0^T)
      float acc[4][RN], hy[4][RN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = hy[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < kQ; ++s) {
        const float d = sdt[s];
        float ev[4], bv[RN];
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[i] = se[(rg + 16 * i) * L::LQ + s] * d;
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = sb[s * L::LB + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(ev[i], bv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < HD; ++p) {
        float dv[4], hv[RN];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = sdy[(rg + 16 * i) * L::LX + p];
#pragma unroll
        for (int j = 0; j < RN; ++j) hv[j] = sh[(cg + 16 * j) * L::LX + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) hy[i][j] = fmaf(dv[i], hv[j], hy[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i, t = t0 + r;
        const float el = sel[r];
        float u = 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = cg + 16 * j;
          const float hyv = el * hy[i][j];
          u = fmaf(sc[r * L::LB + n], hyv, u);
          if (t < S) atomicAdd(dcb + (long long)t * DS + n, acc[i][j] + hyv);
        }
        u = sum16(u);
        if (cg == 0) su[r] = u;
      }
    }

    {  // dB = dt (E^T C + e^(lend - l) (x K^T)); v = dt B . (e^(lend-l) K x)
      float acc[4][RN], kx[4][RN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = kx[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kQ; ++r) {
        float ev[4], cv[RN];
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[i] = se[r * L::LQ + rg + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = sc[r * L::LB + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(ev[i], cv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < HD; ++p) {
        float xv[4], kv[RN];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sx[(rg + 16 * i) * L::LX + p];
#pragma unroll
        for (int j = 0; j < RN; ++j) kv[j] = sk[(cg + 16 * j) * L::LX + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) kx[i][j] = fmaf(xv[i], kv[j], kx[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = rg + 16 * i, t = t0 + s;
        const float e = sed[s], d = sdt[s];
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = cg + 16 * j;
          const float kxv = e * kx[i][j];
          v = fmaf(sb[s * L::LB + n], kxv, v);
          if (t < S) atomicAdd(dbb + (long long)t * DS + n, d * (acc[i][j] + kxv));
        }
        v = sum16(v) * d;
        if (cg == 0) sv[s] = v;
      }
    }

    {  // c = e^lend <K, h0>
      float part = 0.f;
      for (int i = tid; i < DS * HD; i += kThreads) {
        const int o = (i / HD) * L::LX + i % HD;
        part = fmaf(sk[o], sh[o], part);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) atomicAdd(&sscal[1], part);
    }
    __syncthreads();  // every read of K and of the sums' parts is done

    const float lend = sscal[0];
    if (tid < 32) {  // m, ddt and dA's part, two steps a lane
      const float c = expf(lend) * sscal[1];
      const int s0 = 2 * tid, s1 = s0 + 1;
      // running sums over the lanes: W's column sums less its row sums,
      // u from the end, v from the start
      const float w0 = scs[s0] - srs[s0], w1 = scs[s1] - srs[s1];
      float wsum = w0 + w1, vsum = sv[s0] + sv[s1], usum = su[s0] + su[s1];
      float utot = usum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float wu = __shfl_up_sync(0xffffffffu, wsum, off);
        const float vu = __shfl_up_sync(0xffffffffu, vsum, off);
        const float uu = __shfl_up_sync(0xffffffffu, usum, off);
        if (tid >= off) {
          wsum += wu;
          vsum += vu;
          usum += uu;
        }
        utot += __shfl_xor_sync(0xffffffffu, utot, off);
      }
      // wsum and vsum run through s1, usum through s1 from the start:
      // m sums w and v before the step and u from the step on
      const float u1 = utot - usum + su[s1], v0 = vsum - sv[s1];
      const float m1 = (wsum - w1) + u1 + v0 + c;
      const float m0 = (wsum - w1 - w0) + (u1 + su[s0]) + (v0 - sv[s0]) + c;
      if (t0 + s0 < S) ddb[(long long)(t0 + s0) * NH] = fmaf(a, m0, sxz[s0]);
      if (t0 + s1 < S) ddb[(long long)(t0 + s1) * NH] = fmaf(a, m1, sxz[s1]);
      da_acc = fmaf(sdt[s0], m0, fmaf(sdt[s1], m1, da_acc));
    }

    {  // K <- e^lend K + (e^l C)^T dy, each element by its one owner
      const float decay = expf(lend);
      float acc[RN][CJ];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kQ; ++r) {
        const float el = sel[r];
        float cv[RN], yv[CJ];
#pragma unroll
        for (int i = 0; i < RN; ++i) cv[i] = sc[r * L::LB + rg + 16 * i] * el;
#pragma unroll
        for (int j = 0; j < CJ; ++j) yv[j] = sdy[r * L::LX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(cv[i], yv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          float* p = sk + (rg + 16 * i) * L::LX + cg + 16 * j;
          *p = fmaf(decay, *p, acc[i][j]);
        }
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      da_acc += __shfl_xor_sync(0xffffffffu, da_acc, off);
    if (tid == 0) atomicAdd(dA + h, da_acc);
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
  const void *x, *bm, *cm;
  const float *dt, *A;
  const void* dy;
  const float* states;
  void* dx;
  float *dbm, *dcm, *ddt, *dA;
  int B, S, NH;
  Strides xs, bs, cs, dts, dys;
  cudaStream_t stream;
};

template <typename T, int HD, int DS>
cudaError_t launch(const Args& p) {
  static bool ready[64] = {false};
  constexpr int bytes = Smem<HD, DS>::BYTES;
  cudaError_t err = allow_smem(ssd_bwd<T, HD, DS>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.NH, p.B);
  ssd_bwd<T, HD, DS><<<grid, kThreads, bytes, p.stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.bm),
      static_cast<const T*>(p.cm), p.dt, p.A, static_cast<const T*>(p.dy),
      p.states, static_cast<T*>(p.dx), p.dbm, p.dcm, p.ddt, p.dA, p.S, p.NH,
      p.xs, p.bs, p.cs, p.dts, p.dys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_state(const Args& p, int DS) {
  if (DS == 16) return launch<T, 64, 16>(p);
  if (DS == 64) return launch<T, 64, 64>(p);
  if (DS == 128) return launch<T, 64, 128>(p);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of x, B, C, dy and dx): 0 float32, 1 bfloat16. Strides are in
// elements; B and C have no head stride. states is the forward's
// contiguous (B, ceil(S / 64), NH, DS, HD) float32 tensor; dx is a
// contiguous (B, S, NH, HD) tensor, ddt a contiguous (B, S, NH) float32
// tensor; dbm and dcm are contiguous (B, S, DS) and dA (NH,) float32
// tensors that the kernel adds into, so they must hold zeros. Returns a
// CUDA error code (0 on success); cudaErrorInvalidValue for a head size,
// state size or type the library was not built for.
int ssd_chunk_bwd_launch(const void* x, const void* bm, const void* cm,
                         const void* dt, const void* A, const void* dy,
                         const void* states, void* dx, void* dbm, void* dcm,
                         void* ddt, void* dA, int B, int S, int NH, int HD,
                         int DS, int dtype, long long x_sb, long long x_ss,
                         long long x_sh, long long b_sb, long long b_ss,
                         long long c_sb, long long c_ss, long long dt_sb,
                         long long dt_ss, long long dt_sh, long long dy_sb,
                         long long dy_ss, long long dy_sh, void* stream) {
  const Args p{x, bm, cm, static_cast<const float*>(dt),
               static_cast<const float*>(A), dy,
               static_cast<const float*>(states), dx,
               static_cast<float*>(dbm), static_cast<float*>(dcm),
               static_cast<float*>(ddt), static_cast<float*>(dA), B, S, NH,
               Strides{x_sb, x_ss, x_sh}, Strides{b_sb, b_ss, 0},
               Strides{c_sb, c_ss, 0}, Strides{dt_sb, dt_ss, dt_sh},
               Strides{dy_sb, dy_ss, dy_sh},
               static_cast<cudaStream_t>(stream)};
  if (HD != 64) return cudaErrorInvalidValue;
  if (dtype == 0) return by_state<float>(p, DS);
  if (dtype == 1) return by_state<__nv_bfloat16>(p, DS);
  return cudaErrorInvalidValue;
}

}  // extern "C"
