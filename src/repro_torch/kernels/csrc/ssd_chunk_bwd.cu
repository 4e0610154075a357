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
// <g_t, h_t>, cancels where a_t h_{t-1} is small beside dt_t B_t (x) x_t).
// Then ddt_t = A m_t + x_t . z_t and dA sums dt_t m_t. Nothing finer than
// a chunk is stored: each chunk is recomputed from h0.
//
// Bound on an H100 SXM at zamba2-1.2b's train step, B = 4, S = 4096,
// nh = 64, hd = 64, ds = 64, bf16: the function reads x and dy
// (2 x 134,217,728 bytes), B and C (2 x 2,097,152), dt (4,194,304) and
// writes dx (134,217,728), dB and dC (2 x 2,097,152) and ddt (4,194,304):
// 419,430,400 bytes, 0.1252 ms at 3.35 TB/s. Its chunked arithmetic is
// nine (64 x 64 x 64) products a chunk and head, 77.3 GFLOP over the
// 16,384 chunks and heads: 0.078 ms at the bf16 tensor-core rate. It is
// bound by bytes.
//
// bf16: two kernels, launched one after the other by one call. Only K
// needs the chunks in order, and column p of K depends only on column p
// of dy; once K is known, every chunk's gradients depend only on that
// chunk's inputs, its entering state h0 and its K.
//   - ssd_bwd_carry, the carry pass: K <- e^lend K + C^T (e^l dy), in
//     reverse over the chunks, grid (nh, B): 256 CTAs of ds / 16 warps
//     at the step's shape, each warp 16 rows of K (all 64 columns) in f32
//     registers (2 or 4 hd column slices a (batch, head) were no faster).
//     Each chunk's C and dy go by cp.async into one of two stages while
//     the other is computed; the product runs on mma.sync m16n8k16 (C^T
//     by ldmatrix, bf16 as it is), its f32-derived operand e^l dy split
//     into a bf16 high part and a bf16 low part (hi + lo, about 16 bits,
//     as ssd_fwd_mma splits its operands). Before each chunk's update the
//     CTA writes the K entering that chunk into a (B, n_chunks, nh, ds,
//     hd) f32 buffer that the wrapper allocates (268 MB at the step's
//     shape).
//   - ssd_bwd_local, the chunk-local gradients: grid (n_chunks, heads /
//     kHeadGroup, B), 4 warps a CTA, each warp 16 rows of the chunk. The
//     CTA stages B and C once, computes G^T = B C^T once (registers), and
//     walks its G heads. Each head's x, dy, K, h0 and dt arrive by
//     cp.async into one stage once every warp is done with the last
//     head's, and E^T dt later takes the place of K and h0: 112 KB of
//     shared memory at ds 64, so two CTAs share an SM and hide each
//     other's loads (one CTA an SM with two stages was slower). K and h0
//     are split in place into bf16 hi + lo halves (each 8 f32 columns
//     become 8 high then 8 low bf16, so ldmatrix reads either half). All
//     products run on mma.sync m16n8k16 from ldmatrix, in the transposed
//     orientation (rows s): B K, x K^T, dy h0^T, x dy^T (-> Dm^T and E^T
//     in registers, only the blocks r >= s), Dm^T dy, E^T C, and (E dt) B
//     from E^T dt staged in shared memory; every f32 operand (Dm, E, E dt,
//     K, h0) goes in as hi + lo (each low part dropped fails the tight
//     check). dx and ddt are stored directly; dA goes to a part a (batch,
//     chunk, head) that the wrapper sums, in a fixed order; dB and dC are
//     summed over the CTA's heads in f32 in shared memory and leave the
//     CTA once, plain stores when one CTA holds every head (G = nh:
//     deterministic), else f32 atomics, G-fold fewer than one a head.
//   The design moves about 1.37 GB at the step's shape (x, dy twice, the
//   states, K written and read, dx): a floor of 0.41 ms at 3.35 TB/s.
//   Rows past S load as zeros (dt = 0: no decay, no input, no gradient)
//   and are not stored; S < 64 is one ragged chunk. The 16-byte copies
//   need 16-byte aligned rows of x, B, C and dy (the wrapper copies a
//   tensor whose rows are not).
//
// f32: ssd_bwd, the first design, kept for the f32 route (it meets the
// tight f32 limit): one CTA of 256 threads a (batch, head), grid (nh, B),
// walking the chunks in reverse with K in shared memory. Each chunk's x,
// dy, B, C, dt and h0 are staged in shared memory; each thread computes
// 4 x 4 blocks of the (Q, Q) matrices and 4 x (cols / 16) blocks of the
// products with scalar f32 FMAs, rows padded by one float (conflict-free).
// dB and dC sum over the nh heads, which are other CTAs: each CTA adds its
// chunk's rows into f32 buffers with atomicAdd (red.global.add.f32), so
// the order of the nh additions changes from run to run (about 1e-7
// relative in f32); dA adds one value a CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;  // chunk length: the forward's

struct Strides {
  long long b, s, h;
};

// ------------------------------------------------ f32: scalar FMAs
constexpr int kThreads = 256;

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

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_bwd(const float* __restrict__ x, const float* __restrict__ bm,
        const float* __restrict__ cm, const float* __restrict__ dt,
        const float* __restrict__ A, const float* __restrict__ dy,
        const float* __restrict__ states, float* __restrict__ dx,
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
  const float* xb = x + b * xs.b + h * xs.h;
  const float* dyb = dy + b * dys.b + h * dys.h;
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;
  const float* db = dt + b * dts.b + h * dts.h;
  float* dxb = dx + ((long long)b * S * NH + h) * HD;  // contiguous
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
      sx[r * L::LX + p] = ok ? xb[t * xs.s + p] : 0.f;
      sdy[r * L::LX + p] = ok ? dyb[t * dys.s + p] : 0.f;
    }
    for (int i = tid; i < kQ * DS; i += kThreads) {
      const int r = i / DS, n = i % DS, t = t0 + r;
      const bool ok = t < S;
      sb[r * L::LB + n] = ok ? bb[t * bs.s + n] : 0.f;
      sc[r * L::LB + n] = ok ? cb[t * cs.s + n] : 0.f;
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
          if (t < S) dxb[(long long)t * NH * HD + p] = d * z;
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

// ------------------------------------------------ bf16: tensor cores
using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHD = 64;           // the head size the library is built for
constexpr int kHeadGroup = 64;    // heads a chunk-local CTA walks (G)
constexpr int kLocalWarps = 4;    // warps of a chunk-local CTA, 16 rows each
constexpr int kLocalThreads = 32 * kLocalWarps;
constexpr int kLX = kHD + 8;      // x, dy, E^T dt rows (bf16): 16 bytes more
constexpr int kLK = kHD + 4;      // K, h0 rows (f32): 16 bytes more
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float2 pair(const bf16* p) {  // two bf16 as f32
  return unpack(*reinterpret_cast<const uint32_t*>(p));
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
// the sum over the 4 lanes of a fragment row (lane bits 0 and 1)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// The inclusive cumulative sum l of dt A over a chunk's 64 steps, two a
// lane: (l of step 2 lane, l of step 2 lane + 1, lend) in the lanes' order
__device__ __forceinline__ float3 chunk_cumsum(const float* sdt, float a,
                                               int lane) {
  const float a0 = sdt[2 * lane] * a, a1 = sdt[2 * lane + 1] * a;
  float v = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  float before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = 0.f;
  return make_float3(before + a0, v, __shfl_sync(kFull, v, 31));
}

// --- the carry pass
template <int DS>
struct CarrySmem {
  static constexpr int WARPS = DS / 16;            // one a 16-row tile of K
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LC = DS + 8, LY = kHD + 8;  // padded rows (bf16)
  // a stage: C, dy (bf16), dt (f32); two stages, each warp's e^l
  static constexpr int STAGE = (kQ * LC + kQ * LY) * 2 + kQ * 4;
  static constexpr int BYTES = 2 * STAGE + WARPS * kQ * 4;
};

// One chunk's C, dy and dt into a stage (rows past S as zeros)
template <int DS>
__device__ __forceinline__ void load_carry(uint8_t* stage, const bf16* cb,
                                           const bf16* yb, const float* db,
                                           int t0, int S, const Strides& cs,
                                           const Strides& dys,
                                           const Strides& dts, int tid) {
  using L = CarrySmem<DS>;
  constexpr int CV = DS / 8, YV = kHD / 8;  // 16-byte pieces a row
  bf16* sc = reinterpret_cast<bf16*>(stage);
  bf16* sy = sc + kQ * L::LC;
  float* sdt = reinterpret_cast<float*>(sy + kQ * L::LY);
  for (int i = tid; i < kQ * CV; i += L::THREADS) {
    const int r = i / CV, v = i % CV, t = t0 + r;
    const bool ok = t < S;
    cp16(sc + r * L::LC + 8 * v, cb + (ok ? t : 0) * cs.s + 8 * v, ok);
  }
  for (int i = tid; i < kQ * YV; i += L::THREADS) {
    const int r = i / YV, v = i % YV, t = t0 + r;
    const bool ok = t < S;
    cp16(sy + r * L::LY + 8 * v, yb + (ok ? t : 0) * dys.s + 8 * v, ok);
  }
  for (int i = tid; i < kQ; i += L::THREADS) {
    const int t = t0 + i;
    cp4(sdt + i, db + (t < S ? t : 0) * dts.s, t < S);
  }
  cp_commit();
}

template <int DS>
__global__ void __launch_bounds__(CarrySmem<DS>::THREADS)
ssd_bwd_carry(const bf16* __restrict__ cm, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ dy,
              float* __restrict__ carry, int S, int NH, Strides cs,
              Strides dts, Strides dys) {
  using L = CarrySmem<DS>;
  constexpr int NT = kHD / 8;  // n-tiles of K's columns
  static_assert(DS % 16 == 0, "tile sizes");
  extern __shared__ __align__(16) uint8_t dsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int lr = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_chunks = (S + kQ - 1) / kQ;
  const float a = A[h];
  const bf16* cb = cm + b * cs.b;
  const bf16* yb = dy + b * dys.b + h * dys.h;
  const float* db = dt + b * dts.b + h * dts.h;
  float* el = reinterpret_cast<float*>(dsm + 2 * L::STAGE) + warp * kQ;
  // this lane's elements of K: rows 16 warp + g (+ 8), columns 2 q (+ 1)
  // of each n-tile
  const long long per_chunk = (long long)NH * DS * kHD;
  float* out = carry + ((long long)b * n_chunks * NH + h) * DS * kHD +
               (16 * warp + g) * kHD + 2 * q;

  float acc[NT][4];  // this warp's rows of K, f32, across chunks
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (n_chunks > 1)
    load_carry<DS>(dsm, cb, yb, db, (n_chunks - 1) * kQ, S, cs, dys, dts,
                   tid);
  for (int ch = n_chunks - 1;; --ch) {
    float* o = out + ch * per_chunk;  // K entering chunk ch's backward
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(o + 8 * kHD + 8 * j) =
          make_float2(acc[j][2], acc[j][3]);
    }
    if (ch == 0) break;  // chunk 0 sends nothing further back
    const int st = (n_chunks - 1 - ch) & 1;
    // this chunk's stage is in place; every warp is done with the other
    cp_wait_all();
    __syncthreads();
    if (ch > 1)
      load_carry<DS>(dsm + (st ^ 1) * L::STAGE, cb, yb, db, (ch - 1) * kQ, S,
                     cs, dys, dts, tid);
    const uint8_t* stage = dsm + st * L::STAGE;
    const bf16* sc = reinterpret_cast<const bf16*>(stage);
    const bf16* sy = sc + kQ * L::LC;
    const float* sdt = reinterpret_cast<const float*>(sy + kQ * L::LY);

    const float3 l = chunk_cumsum(sdt, a, lane);  // into this warp's row
    el[2 * lane] = expf(l.x);
    el[2 * lane + 1] = expf(l.y);
    __syncwarp();
    const float decay = expf(l.z);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= decay;
    // K += C^T (e^l dy): A = C^T (rows of ds, k over the steps r), B = dy
    // with row r weighed by e^(l_r), as hi + lo
#pragma unroll
    for (int kr = 0; kr < kQ / 16; ++kr) {
      uint32_t ca[4];
      ldsm4t(ca, sc + (16 * kr + lr + 8 * m2) * L::LC + 16 * warp + 8 * m1);
      const int r = 16 * kr + 2 * q;
      const float e0 = el[r], e1 = el[r + 1], e8 = el[r + 8], e9 = el[r + 9];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t yf[4], hi[4], lo[4];
        ldsm4t(yf, sy + (16 * kr + lr + 8 * m1) * L::LY + 16 * np + 8 * m2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // yf[0, 2]: rows r, r + 1; [1, 3]: + 8
          const float2 v = unpack(yf[i]);
          split(v.x * (i & 1 ? e8 : e0), v.y * (i & 1 ? e9 : e1), hi[i],
                lo[i]);
        }
        mma(acc[2 * np], ca, hi[0], hi[1]);
        mma(acc[2 * np + 1], ca, hi[2], hi[3]);
        mma(acc[2 * np], ca, lo[0], lo[1]);
        mma(acc[2 * np + 1], ca, lo[2], lo[3]);
      }
    }
  }
  cp_wait_all();  // S <= 64: nothing in flight; else the loop waited
}

// --- the chunk-local gradients
template <int DS>
struct LocalSmem {
  static constexpr int LB = DS + 8;                // B, C rows (bf16)
  static constexpr int LA = DS + 8;                // dB, dC sums' rows (f32)
  static constexpr int BC = kQ * LB * 2;           // bytes: B or C
  static constexpr int XT = kQ * kLX * 2;          // bytes: x, dy or E^T half
  static constexpr int KT = DS * kLK * 4;          // bytes: K or h0
  // a stage: x, dy (bf16), dt, then K and h0 (f32), where E^T dt's halves
  // (bf16) go once the head's products with K and h0 are done
  static constexpr int KH = 2 * KT > 2 * XT ? 2 * KT : 2 * XT;
  static constexpr int STAGE = 2 * XT + kQ * 4 + KH;
  static constexpr int ACC = kQ * LA * 4;          // bytes: dB or dC sums
  // per row (f32): l, e^l, e^(lend - l), W's column sums below the
  // diagonal, u, v, x . z; each warp's part of W's row sums; lend; each
  // warp's part of <K, h0>
  static constexpr int ROWS = 7 * kQ + kLocalWarps * kQ + 1 + kLocalWarps;
  static constexpr int BYTES = 2 * BC + STAGE + 2 * ACC + ROWS * 4;
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

// One head's x, dy, K, h0 and dt of the chunk into the stage (rows past S
// as zeros); x, dy and dt at the head, K and h0 its (ds, hd) f32 tiles
template <int DS>
__device__ __forceinline__ void load_head(uint8_t* stage, const bf16* xh,
                                          const bf16* yh, const float* kh,
                                          const float* hh, const float* dh,
                                          int t0, int S, const Strides& xs,
                                          const Strides& dys,
                                          const Strides& dts, int tid) {
  bf16* sx = reinterpret_cast<bf16*>(stage);
  bf16* sy = sx + kQ * kLX;
  float* sdt = reinterpret_cast<float*>(sy + kQ * kLX);
  float* sk = sdt + kQ;
  float* sh = sk + DS * kLK;
  for (int i = tid; i < kQ * (kHD / 8); i += kLocalThreads) {
    const int r = i / (kHD / 8), v = i % (kHD / 8), t = t0 + r;
    const bool ok = t < S;
    cp16(sx + r * kLX + 8 * v, xh + (ok ? t : 0) * xs.s + 8 * v, ok);
    cp16(sy + r * kLX + 8 * v, yh + (ok ? t : 0) * dys.s + 8 * v, ok);
  }
  for (int i = tid; i < DS * (kHD / 4); i += kLocalThreads) {
    const int n = i / (kHD / 4), v = i % (kHD / 4);
    cp16(sk + n * kLK + 4 * v, kh + n * kHD + 4 * v, true);
    cp16(sh + n * kLK + 4 * v, hh + n * kHD + 4 * v, true);
  }
  if (tid < kQ) {
    const int t = t0 + tid;
    cp4(sdt + tid, dh + (t < S ? t : 0) * dts.s, t < S);
  }
  cp_commit();
}

// 8 f32 columns at p, in place: their bf16 high parts (16 bytes), then
// their low parts (16 bytes)
__device__ __forceinline__ void split8(float* p, float4 u, float4 w) {
  uint4 hi, lo;
  split(u.x, u.y, hi.x, lo.x);
  split(u.z, u.w, hi.y, lo.y);
  split(w.x, w.y, hi.z, lo.z);
  split(w.z, w.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(p) = hi;
  *reinterpret_cast<uint4*>(p + 4) = lo;
}

template <int DS>
__global__ void __launch_bounds__(kLocalThreads, 2)
ssd_bwd_local(const bf16* __restrict__ x, const bf16* __restrict__ bm,
              const bf16* __restrict__ cm, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ dy,
              const float* __restrict__ states,
              const float* __restrict__ carry, bf16* __restrict__ dx,
              float* __restrict__ dbm, float* __restrict__ dcm,
              float* __restrict__ ddt, float* __restrict__ da_part, int S,
              int NH, Strides xs, Strides bs, Strides cs, Strides dts,
              Strides dys) {
  using L = LocalSmem<DS>;
  constexpr int KD = DS / 16;   // k-steps over ds
  constexpr int ND = DS / 8;    // n-tiles over ds
  constexpr int LB = L::LB, LA = L::LA;
  constexpr int KB = 2 * kLK;   // a K or h0 row in bf16 halves
  static_assert(DS % 16 == 0, "tile sizes");
  extern __shared__ __align__(16) uint8_t dsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row and column pair
  // ldmatrix row addresses: lane's row in an 8x8 matrix, and which matrix
  const int lr = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int ch = blockIdx.x, b = blockIdx.z, n_chunks = gridDim.x;
  const int t0 = ch * kQ;
  const int h_first = blockIdx.y * kHeadGroup;
  const int n_heads = min(kHeadGroup, NH - h_first);
  // this warp's 16 rows of the chunk, and a lane's two of them
  const int i0 = 16 * warp, ra = i0 + g, rb = i0 + g + 8;

  bf16* sb = reinterpret_cast<bf16*>(dsm);  // [kQ][LB]
  bf16* sc = sb + kQ * LB;                  // [kQ][LB]
  uint8_t* stage = dsm + 2 * L::BC;  // one head's tiles
  float* sdb = reinterpret_cast<float*>(stage + L::STAGE);
  float* sdc = sdb + kQ * LA;  // dB, dC sums [kQ][LA]
  float* sl = sdc + kQ * LA;  // l
  float* sexp = sl + kQ;      // e^l
  float* sed = sexp + kQ;     // e^(lend - l)
  float* scs = sed + kQ;      // W's column sums below the diagonal
  float* su = scs + kQ;
  float* sv = su + kQ;
  float* sxz = sv + kQ;
  float* srs = sxz + kQ;      // [warp][r]: W's row sums over a warp's columns
  float* slend = srs + kLocalWarps * kQ;
  float* skh = slend + 1;     // [warp]: parts of <K, h0>

  auto head_load = [&](int h) {
    const long long o =
        (((long long)b * n_chunks + ch) * NH + h) * (long long)(DS * kHD);
    load_head<DS>(stage, x + b * xs.b + h * xs.h,
                  dy + b * dys.b + h * dys.h, carry + o, states + o,
                  dt + b * dts.b + h * dts.h, t0, S, xs, dys, dts, tid);
  };
  {  // B and C, committed with the first head's tiles
    constexpr int V = DS / 8;
    const bf16* bb = bm + b * bs.b;
    const bf16* cb = cm + b * cs.b;
    for (int i = tid; i < kQ * V; i += kLocalThreads) {
      const int r = i / V, v = i % V, t = t0 + r;
      const bool ok = t < S;
      cp16(sb + r * LB + 8 * v, bb + (ok ? t : 0) * bs.s + 8 * v, ok);
      cp16(sc + r * LB + 8 * v, cb + (ok ? t : 0) * cs.s + 8 * v, ok);
    }
  }
  head_load(h_first);
  for (int i = lane; i < 16 * DS; i += 32) {  // this warp's rows of the sums
    const int o = (i0 + i / DS) * LA + i % DS;
    sdb[o] = 0.f;
    sdc[o] = 0.f;
  }

  float gt[4][2][4];  // G^T = B C^T: rows s, the r-blocks jb >= warp
#pragma unroll
  for (int jb = 0; jb < 4; ++jb)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[jb][nt][e] = 0.f;

  for (int hi = 0; hi < n_heads; ++hi) {
    const int h = h_first + hi;
    if (hi > 0) {
      __syncthreads();  // every warp is done with the last head's tiles
      head_load(h);
    }
    cp_wait_all();
    __syncthreads();  // this head's tiles (and, first, B and C) are in
    const bf16* sx = reinterpret_cast<const bf16*>(stage);
    const bf16* sy = sx + kQ * kLX;
    const float* sdt = reinterpret_cast<const float*>(stage + 2 * L::XT);
    float* skf = const_cast<float*>(sdt) + kQ;
    float* shf = skf + DS * kLK;
    const bf16* skb = reinterpret_cast<const bf16*>(skf);
    const bf16* shb = reinterpret_cast<const bf16*>(shf);
    // E^T dt, hi and lo [kQ][kLX], over K and h0 once they are read
    bf16* seh = reinterpret_cast<bf16*>(skf);
    bf16* sel = seh + kQ * kLX;
    const float a = A[h];

    if (hi == 0) {  // G^T, once: bf16 B and C as they are (exact)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ba[4];
        ldsm4(ba, sb + (i0 + lr + 8 * m1) * LB + 16 * kk + 8 * m2);
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (jb < warp) continue;
          uint32_t f[4];
          ldsm4(f, sc + (16 * jb + lr + 8 * m2) * LB + 16 * kk + 8 * m1);
          mma(gt[jb][0], ba, f[0], f[1]);
          mma(gt[jb][1], ba, f[2], f[3]);
        }
      }
    }
    if (warp == 0) {  // l and its exponentials
      const float3 l = chunk_cumsum(sdt, a, lane);
      sl[2 * lane] = l.x;
      sl[2 * lane + 1] = l.y;
      sexp[2 * lane] = expf(l.x);
      sexp[2 * lane + 1] = expf(l.y);
      sed[2 * lane] = expf(l.z - l.x);
      sed[2 * lane + 1] = expf(l.z - l.y);
      if (lane == 0) *slend = l.z;
    }
    {  // K and h0 split into hi + lo in place; <K, h0> in f32 on the way
      float part = 0.f;
      for (int i = tid; i < DS * (kHD / 8); i += kLocalThreads) {
        float* kp = skf + (i / (kHD / 8)) * kLK + 8 * (i % (kHD / 8));
        float* hp = shf + (kp - skf);
        const float4 k0 = *reinterpret_cast<const float4*>(kp);
        const float4 k1 = *reinterpret_cast<const float4*>(kp + 4);
        const float4 h0 = *reinterpret_cast<const float4*>(hp);
        const float4 h1 = *reinterpret_cast<const float4*>(hp + 4);
        part = fmaf(k0.x, h0.x, fmaf(k0.y, h0.y, fmaf(k0.z, h0.z,
               fmaf(k0.w, h0.w, part))));
        part = fmaf(k1.x, h1.x, fmaf(k1.y, h1.y, fmaf(k1.z, h1.z,
               fmaf(k1.w, h1.w, part))));
        split8(kp, k0, k1);
        split8(hp, h0, h1);
      }
      part = warp_sum(part);
      if (lane == 0) skh[warp] = part;
    }
    __syncthreads();  // l, the split halves and the parts are in place

    const float la = sl[ra], lb = sl[rb];
    const float dta = sdt[ra], dtb = sdt[rb];
    const float eda = sed[ra], edb = sed[rb];

    // z = e^(lend - l) (B K): A = B (rows s, k over ds), B operand K
    float z[kHD / 8][4];
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ba[4];
      ldsm4(ba, sb + (i0 + lr + 8 * m1) * LB + 16 * kk + 8 * m2);
#pragma unroll
      for (int np = 0; np < kHD / 16; ++np) {
        const bf16* p = skb + (16 * kk + lr + 8 * m1) * KB + 32 * np + 16 * m2;
        uint32_t kh[4], kl[4];
        ldsm4t(kh, p);
        ldsm4t(kl, p + 8);
        mma(z[2 * np], ba, kh[0], kh[1]);
        mma(z[2 * np + 1], ba, kh[2], kh[3]);
        mma(z[2 * np], ba, kl[0], kl[1]);
        mma(z[2 * np + 1], ba, kl[2], kl[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j) {
      z[j][0] *= eda;
      z[j][1] *= eda;
      z[j][2] *= edb;
      z[j][3] *= edb;
    }

    // dB = e^(lend - l) (x K^T): A = x (rows s, k over hd), B operand K;
    // v = dt B . (that), before E^T C joins it
    uint32_t xa[kHD / 16][4];
#pragma unroll
    for (int kp = 0; kp < kHD / 16; ++kp)
      ldsm4(xa[kp], sx + (i0 + lr + 8 * m1) * kLX + 16 * kp + 8 * m2);
    float db[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kHD / 16; ++kp)
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        const bf16* p = skb + (16 * nn + lr + 8 * m2) * KB + 32 * kp + 16 * m1;
        uint32_t kh[4], kl[4];
        ldsm4(kh, p);
        ldsm4(kl, p + 8);
        mma(db[2 * nn], xa[kp], kh[0], kh[1]);
        mma(db[2 * nn + 1], xa[kp], kh[2], kh[3]);
        mma(db[2 * nn], xa[kp], kl[0], kl[1]);
        mma(db[2 * nn + 1], xa[kp], kl[2], kl[3]);
      }
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      db[j][0] *= eda;
      db[j][1] *= eda;
      db[j][2] *= edb;
      db[j][3] *= edb;
      const float2 b0 = pair(sb + ra * LB + 8 * j + 2 * q);
      const float2 b1 = pair(sb + rb * LB + 8 * j + 2 * q);
      va = fmaf(b0.x, db[j][0], fmaf(b0.y, db[j][1], va));
      vb = fmaf(b1.x, db[j][2], fmaf(b1.y, db[j][3], vb));
    }
    va = quad_sum(va) * dta;
    vb = quad_sum(vb) * dtb;

    {  // dC = e^l (dy h0^T): A = dy (rows r, k over hd), B operand h0,
       // added to the sums of this warp's rows; u = C . (that)
      float dc[ND][4];
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dc[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kHD / 16; ++kp) {
        uint32_t ya[4];
        ldsm4(ya, sy + (i0 + lr + 8 * m1) * kLX + 16 * kp + 8 * m2);
#pragma unroll
        for (int nn = 0; nn < KD; ++nn) {
          const bf16* p =
              shb + (16 * nn + lr + 8 * m2) * KB + 32 * kp + 16 * m1;
          uint32_t hh[4], hl[4];
          ldsm4(hh, p);
          ldsm4(hl, p + 8);
          mma(dc[2 * nn], ya, hh[0], hh[1]);
          mma(dc[2 * nn + 1], ya, hh[2], hh[3]);
          mma(dc[2 * nn], ya, hl[0], hl[1]);
          mma(dc[2 * nn + 1], ya, hl[2], hl[3]);
        }
      }
      const float ela = sexp[ra], elb = sexp[rb];
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float2 c0 = pair(sc + ra * LB + 8 * j + 2 * q);
        const float2 c1 = pair(sc + rb * LB + 8 * j + 2 * q);
        float2* pa = reinterpret_cast<float2*>(sdc + ra * LA + 8 * j + 2 * q);
        float2* pb = reinterpret_cast<float2*>(sdc + rb * LA + 8 * j + 2 * q);
        float2 u = *pa, w = *pb;
        u.x = fmaf(ela, dc[j][0], u.x);
        u.y = fmaf(ela, dc[j][1], u.y);
        w.x = fmaf(elb, dc[j][2], w.x);
        w.y = fmaf(elb, dc[j][3], w.y);
        *pa = u;
        *pb = w;
        ua = fmaf(c0.x, dc[j][0], fmaf(c0.y, dc[j][1], ua));
        ub = fmaf(c1.x, dc[j][2], fmaf(c1.y, dc[j][3], ub));
      }
      ua = quad_sum(ua) * ela;
      ub = quad_sum(ub) * elb;
      if (q == 0) {
        su[ra] = ua;
        su[rb] = ub;
      }
    }
    __syncthreads();  // every warp is done with K and h0: E^T dt goes there

    // The blocks r >= s of x dy^T, decayed into Dm^T and E^T (A operands
    // of one k-step each, hi + lo), with W's sums; then z += Dm^T dy, dB
    // += E^T C, and E^T dt into shared memory for (E dt) B
    float csa = 0.f, csb = 0.f;  // W's column sums (rows ra, rb here)
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      if (jb < warp) continue;
      float pt[2][4] = {};
#pragma unroll
      for (int kp = 0; kp < kHD / 16; ++kp) {
        uint32_t f[4];
        ldsm4(f, sy + (16 * jb + lr + 8 * m2) * kLX + 16 * kp + 8 * m1);
        mma(pt[0], xa[kp], f[0], f[1]);
        mma(pt[1], xa[kp], f[2], f[3]);
      }
      float dm[2][4], ee[2][4], col[2][2] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * jb + 8 * nt + 2 * q + (e & 1);
          const bool low = e >> 1;
          const int s = low ? rb : ra;
          const float dec =
              r >= s ? ex2((sl[r] - (low ? lb : la)) * kLog2e) : 0.f;
          dm[nt][e] = gt[jb][nt][e] * dec;
          ee[nt][e] = pt[nt][e] * dec;
          const float w = r > s ? dm[nt][e] * (low ? dtb : dta) * pt[nt][e]
                                : 0.f;
          if (low)
            csb += w;
          else
            csa += w;
          col[nt][e & 1] += w;
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {  // over this warp's rows s
          float v = col[nt][c2];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (g == 0) srs[warp * kQ + 16 * jb + 8 * nt + 2 * q + c2] = v;
        }
      uint32_t dh[4], dl[4], eh[4], el[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // fragment i: n-tile i / 2, rows i % 2
        split(dm[i >> 1][2 * (i & 1)], dm[i >> 1][2 * (i & 1) + 1], dh[i],
              dl[i]);
        split(ee[i >> 1][2 * (i & 1)], ee[i >> 1][2 * (i & 1) + 1], eh[i],
              el[i]);
      }
#pragma unroll
      for (int np = 0; np < kHD / 16; ++np) {  // z += Dm^T dy
        uint32_t f[4];
        ldsm4t(f, sy + (16 * jb + lr + 8 * m1) * kLX + 16 * np + 8 * m2);
        mma(z[2 * np], dh, f[0], f[1]);
        mma(z[2 * np + 1], dh, f[2], f[3]);
        mma(z[2 * np], dl, f[0], f[1]);
        mma(z[2 * np + 1], dl, f[2], f[3]);
      }
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {  // dB += E^T C
        uint32_t f[4];
        ldsm4t(f, sc + (16 * jb + lr + 8 * m1) * LB + 16 * nn + 8 * m2);
        mma(db[2 * nn], eh, f[0], f[1]);
        mma(db[2 * nn + 1], eh, f[2], f[3]);
        mma(db[2 * nn], el, f[0], f[1]);
        mma(db[2 * nn + 1], el, f[2], f[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // E^T dt, rows s, columns r
        const int r = 16 * jb + 8 * nt + 2 * q;
        uint32_t h2, l2;
        split(ee[nt][0] * dta, ee[nt][1] * dta, h2, l2);
        *reinterpret_cast<uint32_t*>(seh + ra * kLX + r) = h2;
        *reinterpret_cast<uint32_t*>(sel + ra * kLX + r) = l2;
        split(ee[nt][2] * dtb, ee[nt][3] * dtb, h2, l2);
        *reinterpret_cast<uint32_t*>(seh + rb * kLX + r) = h2;
        *reinterpret_cast<uint32_t*>(sel + rb * kLX + r) = l2;
      }
    }

    // dx = dt z, stored; x . z
    {
      const bool oka = t0 + ra < S, okb = t0 + rb < S;
      bf16* dxa = dx + (((long long)b * S + t0 + ra) * NH + h) * kHD + 2 * q;
      bf16* dxb = dx + (((long long)b * S + t0 + rb) * NH + h) * kHD + 2 * q;
      float xza = 0.f, xzb = 0.f;
#pragma unroll
      for (int j = 0; j < kHD / 8; ++j) {
        const float2 x0 = pair(sx + ra * kLX + 8 * j + 2 * q);
        const float2 x1 = pair(sx + rb * kLX + 8 * j + 2 * q);
        xza = fmaf(x0.x, z[j][0], fmaf(x0.y, z[j][1], xza));
        xzb = fmaf(x1.x, z[j][2], fmaf(x1.y, z[j][3], xzb));
        if (oka)
          *reinterpret_cast<__nv_bfloat162*>(dxa + 8 * j) =
              __floats2bfloat162_rn(dta * z[j][0], dta * z[j][1]);
        if (okb)
          *reinterpret_cast<__nv_bfloat162*>(dxb + 8 * j) =
              __floats2bfloat162_rn(dtb * z[j][2], dtb * z[j][3]);
      }
      xza = quad_sum(xza);
      xzb = quad_sum(xzb);
      csa = quad_sum(csa);
      csb = quad_sum(csb);
      if (q == 0) {
        sxz[ra] = xza;
        sxz[rb] = xzb;
        scs[ra] = csa;
        scs[rb] = csb;
        sv[ra] = va;
        sv[rb] = vb;
      }
    }
    // this head's dB = dt (...), added to the sums of this warp's rows
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      float2* pa = reinterpret_cast<float2*>(sdb + ra * LA + 8 * j + 2 * q);
      float2* pb = reinterpret_cast<float2*>(sdb + rb * LA + 8 * j + 2 * q);
      float2 u = *pa, w = *pb;
      u.x = fmaf(dta, db[j][0], u.x);
      u.y = fmaf(dta, db[j][1], u.y);
      w.x = fmaf(dtb, db[j][2], w.x);
      w.y = fmaf(dtb, db[j][3], w.y);
      *pa = u;
      *pb = w;
    }

    __syncthreads();  // E^T dt, the row sums' parts, u, v, x . z are in

    // dC += (E dt) B over the blocks s <= r: A = (E^T dt)^T, B operand B
    float dc[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb > warp) continue;
      uint32_t ah[4], al[4];
      ldsm4t(ah, seh + (16 * kb + lr + 8 * m2) * kLX + i0 + 8 * m1);
      ldsm4t(al, sel + (16 * kb + lr + 8 * m2) * kLX + i0 + 8 * m1);
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        uint32_t f[4];
        ldsm4t(f, sb + (16 * kb + lr + 8 * m1) * LB + 16 * nn + 8 * m2);
        mma(dc[2 * nn], ah, f[0], f[1]);
        mma(dc[2 * nn + 1], ah, f[2], f[3]);
        mma(dc[2 * nn], al, f[0], f[1]);
        mma(dc[2 * nn + 1], al, f[2], f[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      float2* pa = reinterpret_cast<float2*>(sdc + ra * LA + 8 * j + 2 * q);
      float2* pb = reinterpret_cast<float2*>(sdc + rb * LA + 8 * j + 2 * q);
      float2 u = *pa, w = *pb;
      u.x += dc[j][0];
      u.y += dc[j][1];
      w.x += dc[j][2];
      w.y += dc[j][3];
      *pa = u;
      *pb = w;
    }

    if (warp == 0) {  // m, ddt and this head's part of dA, two steps a lane
      float kh = 0.f;
#pragma unroll
      for (int w = 0; w < kLocalWarps; ++w) kh += skh[w];
      const float c = expf(*slend) * kh;
      const int s0 = 2 * lane, s1 = s0 + 1;
      float r0 = 0.f, r1 = 0.f;  // W's row sums: the warps of rows s < r
      for (int w = 0; w <= s0 / 16; ++w) {
        r0 += srs[w * kQ + s0];
        r1 += srs[w * kQ + s1];
      }
      // running sums over the lanes: W's column sums less its row sums,
      // u from the end, v from the start
      const float w0 = scs[s0] - r0, w1 = scs[s1] - r1;
      float wsum = w0 + w1, vsum = sv[s0] + sv[s1], usum = su[s0] + su[s1];
      float utot = usum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float wu = __shfl_up_sync(kFull, wsum, off);
        const float vu = __shfl_up_sync(kFull, vsum, off);
        const float uu = __shfl_up_sync(kFull, usum, off);
        if (lane >= off) {
          wsum += wu;
          vsum += vu;
          usum += uu;
        }
        utot += __shfl_xor_sync(kFull, utot, off);
      }
      // wsum and vsum run through s1, usum through s1 from the start: m
      // sums w and v before the step and u from the step on
      const float u1 = utot - usum + su[s1], v0 = vsum - sv[s1];
      const float mt1 = (wsum - w1) + u1 + v0 + c;
      const float mt0 = (wsum - w1 - w0) + (u1 + su[s0]) + (v0 - sv[s0]) + c;
      float* dd = ddt + ((long long)b * S + t0) * NH + h;
      if (t0 + s0 < S) dd[(long long)s0 * NH] = fmaf(a, mt0, sxz[s0]);
      if (t0 + s1 < S) dd[(long long)s1 * NH] = fmaf(a, mt1, sxz[s1]);
      const float da = warp_sum(fmaf(sdt[s0], mt0, sdt[s1] * mt1));
      if (lane == 0) da_part[((long long)b * n_chunks + ch) * NH + h] = da;
    }
  }

  __syncthreads();  // every warp's rows of the sums are in
  // dB and dC of the chunk over this CTA's heads: stored when the CTA holds
  // every head, else added to the other CTAs'
  const bool whole = gridDim.y == 1;
  for (int i = tid; i < kQ * DS; i += kLocalThreads) {
    const int r = i / DS, n = i % DS, t = t0 + r;
    if (t >= S) continue;
    const long long o = ((long long)b * S + t) * DS + n;
    if (whole) {
      dbm[o] = sdb[r * LA + n];
      dcm[o] = sdc[r * LA + n];
    } else {
      atomicAdd(dbm + o, sdb[r * LA + n]);
      atomicAdd(dcm + o, sdc[r * LA + n]);
    }
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
  float* carry;  // bf16: the carry pass's K entering each chunk
  void* dx;
  float *dbm, *dcm, *ddt, *dA;
  int B, S, NH;
  Strides xs, bs, cs, dts, dys;
  cudaStream_t stream;
};

// dB's and dC's f32 sums zeroed, for kernels that add into them
template <int DS>
cudaError_t zero_sums(const Args& p) {
  const size_t bytes = sizeof(float) * p.B * p.S * DS;
  cudaError_t err = cudaMemsetAsync(p.dbm, 0, bytes, p.stream);
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(p.dcm, 0, bytes, p.stream);
}

template <int DS>
cudaError_t launch_f32(const Args& p) {
  static bool ready[64] = {false};
  constexpr int bytes = Smem<64, DS>::BYTES;
  cudaError_t err = allow_smem(ssd_bwd<64, DS>, bytes, ready);
  if (err != cudaSuccess) return err;
  err = zero_sums<DS>(p);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.NH, p.B);
  ssd_bwd<64, DS><<<grid, kThreads, bytes, p.stream>>>(
      static_cast<const float*>(p.x), static_cast<const float*>(p.bm),
      static_cast<const float*>(p.cm), p.dt, p.A,
      static_cast<const float*>(p.dy), p.states, static_cast<float*>(p.dx),
      p.dbm, p.dcm, p.ddt, p.dA, p.S, p.NH, p.xs, p.bs, p.cs, p.dts, p.dys);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_carry(const Args& p) {
  static bool ready[64] = {false};
  using L = CarrySmem<DS>;
  cudaError_t err = allow_smem(ssd_bwd_carry<DS>, L::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.NH, p.B);
  ssd_bwd_carry<DS><<<grid, L::THREADS, L::BYTES, p.stream>>>(
      static_cast<const bf16*>(p.cm), p.dt, p.A,
      static_cast<const bf16*>(p.dy), p.carry, p.S, p.NH, p.cs, p.dts,
      p.dys);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_bf16(const Args& p) {
  static bool ready[64] = {false};
  constexpr int bytes = LocalSmem<DS>::BYTES;
  cudaError_t err = launch_carry<DS>(p);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_bwd_local<DS>, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kQ - 1) / kQ, (p.NH + kHeadGroup - 1) / kHeadGroup,
                  p.B);
  if (grid.y > 1) {  // else one CTA holds every head and stores dB and dC
    err = zero_sums<DS>(p);
    if (err != cudaSuccess) return err;
  }
  ssd_bwd_local<DS><<<grid, kLocalThreads, bytes, p.stream>>>(
      static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.bm),
      static_cast<const bf16*>(p.cm), p.dt, p.A,
      static_cast<const bf16*>(p.dy), p.states, p.carry,
      static_cast<bf16*>(p.dx), p.dbm, p.dcm, p.ddt, p.dA, p.S, p.NH, p.xs,
      p.bs, p.cs, p.dts, p.dys);
  return cudaGetLastError();
}

template <template <int> class Launch>
cudaError_t by_state(const Args& p, int DS) {
  if (DS == 16) return Launch<16>::run(p);
  if (DS == 64) return Launch<64>::run(p);
  if (DS == 128) return Launch<128>::run(p);
  return cudaErrorInvalidValue;
}
template <int DS>
struct F32 {
  static cudaError_t run(const Args& p) { return launch_f32<DS>(p); }
};
template <int DS>
struct Bf16 {
  static cudaError_t run(const Args& p) { return launch_bf16<DS>(p); }
};
template <int DS>
struct Carry {
  static cudaError_t run(const Args& p) { return launch_carry<DS>(p); }
};

}  // namespace

extern "C" {

// dtype (of x, B, C, dy and dx): 0 float32 (the scalar kernel), 1 bfloat16
// (the carry pass, then the chunk-local kernel). Strides are in elements;
// B and C have no head stride; bf16 rows of x, B, C and dy must be 16-byte
// aligned. states is the forward's contiguous (B, ceil(S / 64), NH, DS, HD)
// float32 tensor; dx is a contiguous (B, S, NH, HD) tensor, ddt a
// contiguous (B, S, NH) float32 tensor; dbm and dcm are contiguous (B, S,
// DS) float32 tensors that receive dB and dC (zeroed here where the
// kernels add into them).
// float32: carry is unused and dA an (NH,) float32 tensor of zeros that the
// kernel adds into. bfloat16: carry is a float32 scratch tensor of the
// states' shape, and dA a (B * ceil(S / 64), NH) float32 tensor that
// receives each (batch, chunk, head)'s part of dA, for the caller to sum.
// Returns a CUDA error code (0 on success); cudaErrorInvalidValue for a
// head size, state size or type the library was not built for.
int ssd_chunk_bwd_launch(const void* x, const void* bm, const void* cm,
                         const void* dt, const void* A, const void* dy,
                         const void* states, void* carry, void* dx,
                         void* dbm, void* dcm, void* ddt, void* dA, int B,
                         int S, int NH, int HD, int DS, int dtype,
                         long long x_sb, long long x_ss, long long x_sh,
                         long long b_sb, long long b_ss, long long c_sb,
                         long long c_ss, long long dt_sb, long long dt_ss,
                         long long dt_sh, long long dy_sb, long long dy_ss,
                         long long dy_sh, void* stream) {
  const Args p{x, bm, cm, static_cast<const float*>(dt),
               static_cast<const float*>(A), dy,
               static_cast<const float*>(states), static_cast<float*>(carry),
               dx, static_cast<float*>(dbm), static_cast<float*>(dcm),
               static_cast<float*>(ddt), static_cast<float*>(dA), B, S, NH,
               Strides{x_sb, x_ss, x_sh}, Strides{b_sb, b_ss, 0},
               Strides{c_sb, c_ss, 0}, Strides{dt_sb, dt_ss, dt_sh},
               Strides{dy_sb, dy_ss, dy_sh},
               static_cast<cudaStream_t>(stream)};
  if (HD != kHD || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || NH == 0) return cudaSuccess;
  if (dtype == 0) return by_state<F32>(p, DS);
  return by_state<Bf16>(p, DS);
}

// The bf16 carry pass alone (its check against the plain version): the K
// entering each chunk's backward into carry, a contiguous (B, ceil(S /
// 64), NH, DS, 64) float32 tensor, from bf16 C and dy and float32 dt and A.
int ssd_chunk_bwd_carry_launch(const void* cm, const void* dt, const void* A,
                               const void* dy, void* carry, int B, int S,
                               int NH, int HD, int DS, long long c_sb,
                               long long c_ss, long long dt_sb,
                               long long dt_ss, long long dt_sh,
                               long long dy_sb, long long dy_ss,
                               long long dy_sh, void* stream) {
  const Args p{nullptr, nullptr, cm, static_cast<const float*>(dt),
               static_cast<const float*>(A), dy, nullptr,
               static_cast<float*>(carry), nullptr, nullptr, nullptr,
               nullptr, nullptr, B, S, NH, Strides{0, 0, 0}, Strides{0, 0, 0},
               Strides{c_sb, c_ss, 0}, Strides{dt_sb, dt_ss, dt_sh},
               Strides{dy_sb, dy_ss, dy_sh},
               static_cast<cudaStream_t>(stream)};
  if (HD != kHD) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || NH == 0) return cudaSuccess;
  return by_state<Carry>(p, DS);
}

}  // extern "C"
