// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in
// src/repro/kernels/ssd_scan/kernel.py (body `_kernel`, wrapper
// `ops.ssd_chunked_scan`).  For every (row, head) it computes the
// state-space recurrence over pre-activated inputs
//   h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T     (P x N state, zero at t = 0)
//   y_t = h_t C_t
// in its chunked (state-space dual) form: within a tile of T tokens
//   M   = (C B^T) o L,   L[q][t] = exp(cum_q - cum_t) for t <= q, else 0
//   y   = M (x dt) + exp(cum) (C h)
//   h'  = exp(cum_last) h + (B wt)^T (x dt),   wt[t] = exp(cum_last - cum_t)
// with cum the running sum of da inside the tile.  The chunked form equals
// the recurrence in exact arithmetic for any tile length, so the tile need
// not be the caller's chunk; only the rounding differs.  B and C arrive
// unexpanded, (b, S, G, N): head h reads group h / (H / G).  The causal mask
// is applied before exp (above the diagonal cum_q - cum_t > 0, where exp may
// overflow and inf * 0 is NaN).  Rows past S are zeros with dt = da = 0, so
// they leave h alone.
//
// What bounds it on the H100: the bytes.  At the serving shapes (H = 48
// heads, P = 64, N = 128, one group, b = 4, S = 512) x, B, C, dt, da are read
// once and y (f32) and the final state written once: about 46 MB, 13.7 us at
// 3.35 TB/s, against some 13 GFLOP of the reference's chunked products.
//
// Two kernels, chosen by dtype.
//
// bf16: `ssd_wgmma_kernel`, one warpgroup (128 threads) per (head, row)
// walking the sequence in 64-token tiles, the row count of a wgmma tile;
// P <= 64 and N <= 128 (multiples of 16) run in the one 64 x 128 instance,
// TMA filling the rest with zeros.  The design:
//   * x (64 x P) and B (64 x N) tiles arrive by TMA in a ring of two stages,
//     C (64 x N) in one buffer refilled as soon as the tile's first products
//     have read it, all in the 128-byte swizzle the wgmma descriptors name;
//     the copies of tile j + 1 run under tile j's math;
//   * C B^T is one wgmma product (bf16 in, f32 out; each bf16 x bf16
//     product is exact in f32);
//   * the reference's bar is 2e-4, which one bf16 rounding of M, h or the
//     weighted x misses by 30-40x; so each of the three is split into a bf16
//     hi part and a bf16 lo part (hi + lo keeps about 16 bits) and enters
//     its product twice, which keeps the error at that of f32 summation:
//       - M' = (C B^T) o L o dt_t, built in registers from C B^T's
//         accumulator, is wgmma's A operand as it lies (the accumulator
//         fragment is the A fragment); y += M'_hi x + M'_lo x, x from
//         shared memory;
//       - h (P x N, f32) stays in the warpgroup's accumulator registers from
//         tile to tile; each tile writes h_hi and h_lo to shared memory
//         for y_off = exp(cum) (C h_hi^T + C h_lo^T);
//       - the state update h <- exp(cum_last) h + (x o wt dt)^T B puts the
//         weights on x: its transpose is read from the x tile into A
//         fragments, scaled and split, and B is the operand from shared
//         memory as it arrived;
//   * the running sums of da are one warp's shuffle scan, a tile ahead.
//
// f32: `ssd_f32_kernel`, on the CUDA cores: TF32 tensor cores keep about
// three digits, short of 2e-4.  One block owns a (row, head, kPB-column
// slice of P) and walks the sequence in 32-token tiles, keeping its slice
// of h in shared memory (padded rows keep the column walks free of bank
// conflicts).

#include "hopper.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------- f32

constexpr int kT = 32;         // tokens per tile
constexpr int kPB = 32;        // columns of P per block
constexpr int kMaxN = 128;     // state size the register tiles cover
constexpr int kThreads = 256;  // 8 warps

__global__ void __launch_bounds__(kThreads) ssd_f32_kernel(
    const float* __restrict__ x,         // (b, S, H, P)
    const float* __restrict__ Bm,        // (b, S, G, N)
    const float* __restrict__ Cm,        // (b, S, G, N)
    const float* __restrict__ dt,    // (b, S, H)
    const float* __restrict__ da,    // (b, S, H)
    float* __restrict__ y,           // (b, S, H, P)
    float* __restrict__ h_last,      // (b, H, P, N)
    int S, int H, int P, int G, int N) {
  extern __shared__ float smem[];
  const int ns = N + 1;                    // padded stride of N-wide rows
  constexpr int ms = kT + 1;               // padded stride of M rows
  float* h_s = smem;                       // kPB x ns: state columns p0 ..
  float* b_s = h_s + kPB * ns;             // kT x ns: B, then B * wt
  float* c_s = b_s + kT * ns;              // kT x ns: C
  float* x_s = c_s + kT * ns;              // kT x kPB: x * dt
  float* m_s = x_s + kT * kPB;             // kT x ms: M
  float* cum_s = m_s + kT * ms;            // kT: running sum of da
  float* wt_s = cum_s + kT;                // kT: exp(cum_last - cum_t)
  float* dq_s = wt_s + kT;                 // kT: exp(cum_q)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kPB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);

  const size_t xrow = (size_t)H * P;       // token stride of x and y
  const size_t brow = (size_t)G * N;       // token stride of B and C
  const float* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  const float* bb = Bm + (size_t)b * S * brow + (size_t)g * N;
  const float* cb = Cm + (size_t)b * S * brow + (size_t)g * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  const float* dab = da + (size_t)b * S * H + h;
  float* yb = y + (size_t)b * S * xrow + (size_t)h * P;

  for (int e = tid; e < kPB * ns; e += kThreads) h_s[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kT) {
    const int nt = min(kT, S - s0);
    __syncthreads();                       // the last tile's readers are done

    // 1. load the tile; rows past the end are zeros, which leave h alone
    for (int e = tid; e < kT * N; e += kThreads) {
      const int t = e / N;
      const int n = e - t * N;
      const bool ok = t < nt;
      const size_t src = (size_t)(s0 + t) * brow + n;
      b_s[t * ns + n] = ok ? bb[src] : 0.f;
      c_s[t * ns + n] = ok ? cb[src] : 0.f;
    }
    for (int e = tid; e < kT * kPB; e += kThreads) {
      const int t = e / kPB;
      const int p = e - t * kPB;
      const bool ok = t < nt && p0 + p < P;
      x_s[e] = ok ? xb[(size_t)(s0 + t) * xrow + p0 + p] *
                        dtb[(size_t)(s0 + t) * H]
                  : 0.f;
    }
    if (warp == 0) {                       // inclusive prefix sum, kT == 32
      float v = lane < nt ? dab[(size_t)(s0 + lane) * H] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, 31);
      cum_s[lane] = v;
      wt_s[lane] = expf(last - v);
      dq_s[lane] = expf(v);
    }
    __syncthreads();

    // 2. M[q][t] = (C_q . B_t) exp(cum_q - cum_t) for t <= q, 0 above
    {
      const int q = tid >> 3;              // 32 query rows
      const int t0 = (tid & 7) * 4;        // 4 keys each
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t0 <= q) {
        const float* cr = c_s + q * ns;
        for (int n = 0; n < N; ++n) {
          const float cv = cr[n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] += cv * b_s[(t0 + i) * ns + n];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + i;
        m_s[q * ms + t] = t <= q ? acc[i] * expf(cum_s[q] - cum_s[t]) : 0.f;
      }
    }
    __syncthreads();

    // 3. y[q][p] = sum_{t <= q} M[q][t] xdt[t][p] + exp(cum_q) (C_q . h_p);
    //    B is not read again before the state update, so scale it by wt here
    {
      const int q = tid >> 3;
      const int pl = (tid & 7) * 4;        // 4 columns each
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* mr = m_s + q * ms;
      for (int t = 0; t <= q; ++t) {
        const float mv = mr[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += mv * x_s[t * kPB + pl + i];
      }
      float off[4] = {0.f, 0.f, 0.f, 0.f};
      const float* cr = c_s + q * ns;
      for (int n = 0; n < N; ++n) {
        const float cv = cr[n];
#pragma unroll
        for (int i = 0; i < 4; ++i) off[i] += cv * h_s[(pl + i) * ns + n];
      }
      const float dq = dq_s[q];
      if (q < nt) {
        float* yr = yb + (size_t)(s0 + q) * xrow + p0 + pl;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (p0 + pl + i < P) yr[i] = acc[i] + off[i] * dq;
      }
    }
    for (int e = tid; e < kT * N; e += kThreads) {
      const int t = e / N;
      b_s[t * ns + (e - t * N)] *= wt_s[t];
    }
    __syncthreads();

    // 4. h[p][n] = exp(cum_last) h[p][n] + sum_t xdt[t][p] (B wt)[t][n]
    {
      const int pl = warp * 4;             // 8 warps x 4 columns
      float acc[4][kMaxN / 32] = {};
      for (int t = 0; t < nt; ++t) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[t * kPB + pl + i];
#pragma unroll
        for (int j = 0; j < kMaxN / 32; ++j) {
          const int n = lane + 32 * j;
          if (n < N) {
            const float bv = b_s[t * ns + n];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += xv[i] * bv;
          }
        }
      }
      const float decay = dq_s[kT - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kMaxN / 32; ++j) {
          const int n = lane + 32 * j;
          if (n < N) {
            float* hp = h_s + (pl + i) * ns + n;
            *hp = *hp * decay + acc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();

  float* hb = h_last + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < kPB * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    if (p0 + p < P) hb[(size_t)(p0 + p) * N + n] = h_s[p * ns + n];
  }
}

size_t f32_smem(int N) {
  return sizeof(float) *
      ((size_t)kPB * (N + 1) + 2 * (size_t)kT * (N + 1) + (size_t)kT * kPB +
       (size_t)kT * (kT + 1) + 3 * (size_t)kT);
}

cudaError_t launch_f32(const void* x, const void* B, const void* C,
                       const float* dt, const float* da, float* y,
                       float* h_last, int b, int S, int H, int P, int G, int N,
                       cudaStream_t stream) {
  // once per process: the largest request, that of N = kMaxN
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_smem(kMaxN));
  if (attr != cudaSuccess) return attr;
  dim3 grid((P + kPB - 1) / kPB, H, b);
  ssd_f32_kernel<<<grid, kThreads, f32_smem(N), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), dt, da, y, h_last, S, H, P, G, N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kTW = 64;              // tokens per tile: wgmma's rows
constexpr int kPW = 64;              // P of the instance
constexpr int kNW = 128;             // N of the instance
constexpr int kBox = 64 * 128;       // one TMA box: 64 rows of 64 bf16, bytes
constexpr int kArr = 4 * kTW + 4;    // floats per tile of per-token values
// byte offsets from the 1024-aligned base: x[2], B[2], C, h_hi, h_lo,
// per-token values [2], mbarriers (x and B of each stage, C)
constexpr uint32_t kXs = 0;
constexpr uint32_t kBs = kXs + 2 * kBox;
constexpr uint32_t kCs = kBs + 4 * kBox;
constexpr uint32_t kHhi = kCs + 2 * kBox;
constexpr uint32_t kHlo = kHhi + 2 * kBox;
constexpr uint32_t kVals = kHlo + 2 * kBox;
constexpr uint32_t kBars = kVals + 2 * kArr * 4;
constexpr size_t kSmemW = kBars + 3 * 8 + 1024;   // 1 KB of slack for alignment

// a 128-byte-swizzled tile of 64-column boxes: byte offset of (row, col)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return (col >> 6) * kBox + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

__global__ void __launch_bounds__(128) ssd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x,   // (b, S, H, P) bf16
    const __grid_constant__ CUtensorMap tm_b,   // (b, S, G, N) bf16
    const __grid_constant__ CUtensorMap tm_c,   // (b, S, G, N) bf16
    const float* __restrict__ dt,               // (b, S, H)
    const float* __restrict__ da,               // (b, S, H)
    float* __restrict__ y,                      // (b, S, H, P)
    float* __restrict__ h_last,                 // (b, H, P, N)
    int S, int H, int P, int G, int N) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto xs = [&](int s) { return base + kXs + s * kBox; };
  auto bs = [&](int s) { return base + kBs + s * 2 * kBox; };
  const uint32_t cs = base + kCs;
  const uint32_t bar_c = base + kBars;
  auto bar_xb = [&](int s) { return base + kBars + 8 + 8 * s; };
  // per-token values of a tile: cum, dt, wt * dt, exp(cum); exp(cum_last)
  float* vals = reinterpret_cast<float*>(gbase + kVals);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int n_tiles = (S + kTW - 1) / kTW;
  const int n_boxes = N > 64 ? 2 : 1;
  const float* dtb = dt + (size_t)b * S * H + h;
  const float* dab = da + (size_t)b * S * H + h;

  auto load_xb = [&](int s, int j) {
    mbar_expect_tx(bar_xb(s), (1 + n_boxes) * kBox);
    tma_load(xs(s), &tm_x, bar_xb(s), 0, h, j * kTW, b);
    for (int c = 0; c < n_boxes; ++c)
      tma_load(bs(s) + c * kBox, &tm_b, bar_xb(s), 64 * c, g, j * kTW, b);
  };
  auto load_c = [&](int j) {
    mbar_expect_tx(bar_c, n_boxes * kBox);
    for (int c = 0; c < n_boxes; ++c)
      tma_load(cs + c * kBox, &tm_c, bar_c, 64 * c, g, j * kTW, b);
  };

  // warp 0 reads dt and da of a tile a tile ahead (tokens 2 lane, 2 lane
  // + 1) and scans them into the per-token values
  float pdt[2] = {0.f, 0.f}, pda[2] = {0.f, 0.f};
  auto fetch = [&](int j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = j * kTW + 2 * lane + e;
      const bool ok = j < n_tiles && t < S;
      pdt[e] = ok ? dtb[(size_t)t * H] : 0.f;
      pda[e] = ok ? dab[(size_t)t * H] : 0.f;
    }
  };
  auto scan = [&](float* v) {
    float inc = pda[0] + pda[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    const float last = __shfl_sync(0xffffffffu, inc, 31);
    const float c[2] = {inc - pda[1], inc};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      v[t] = c[e];
      v[kTW + t] = pdt[e];
      v[2 * kTW + t] = expf(last - c[e]) * pdt[e];
      v[3 * kTW + t] = expf(c[e]);
    }
    if (lane == 0) v[4 * kTW] = expf(last);
  };

  if (tid == 0) {
    mbar_init(bar_c, 1);
    mbar_init(bar_xb(0), 1);
    mbar_init(bar_xb(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_boxes == 1) {                    // N <= 64: B and C's second box stays 0
    for (int e = tid; e < 3 * kBox / 16; e += blockDim.x) {
      const int which = e / (kBox / 16);
      const uint32_t off = which == 2 ? kCs : kBs + which * 2 * kBox;
      reinterpret_cast<uint4*>(gbase + off + kBox)[e % (kBox / 16)] = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();
  if (tid == 0) {
    load_xb(0, 0);
    load_c(0);
  }
  if (warp == 0) {
    fetch(0);
    scan(vals);
    fetch(1);
  }
  __syncthreads();

  // accumulator fragments: this thread holds rows r0 and r0 + 8 of a
  // 64-row tile, columns 8 i + cq and 8 i + cq + 1 of every 8-column block i
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float hacc[64];                        // h: rows p, columns n
#pragma unroll
  for (int i = 0; i < 64; ++i) hacc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const float* v = vals + s * kArr;
    if (tid == 0 && j + 1 < n_tiles) load_xb(s ^ 1, j + 1);
    mbar_wait(bar_xb(s), (j >> 1) & 1);
    mbar_wait(bar_c, j & 1);

    // C B^T, and y_off = C h_hi^T + C h_lo^T (h = 0 on the first tile)
    float sc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = yacc[i] = 0.f;
    fence_regs<32>(sc);
    fence_regs<32>(yacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kNW / 16; ++ks) {
      const uint32_t koff = (ks >> 2) * kBox + (ks & 3) * 32;
      wgmma_ss_m64n64(sc, smem_desc(cs + koff, 16, 1024, 1),
                      smem_desc(bs(s) + koff, 16, 1024, 1), 1);
    }
    if (j > 0) {
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int ks = 0; ks < kNW / 16; ++ks) {
          const uint32_t koff = (ks >> 2) * kBox + (ks & 3) * 32;
          wgmma_ss_m64n64(yacc, smem_desc(cs + koff, 16, 1024, 1),
                          smem_desc(base + (part ? kHlo : kHhi) + koff, 16, 1024, 1), 1);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(yacc);
    __syncthreads();                     // C and the h tiles are read
    if (tid == 0 && j + 1 < n_tiles) load_c(j + 1);

    float cum_q[2], ecum_q[2];
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      cum_q[jr] = v[r0 + 8 * jr];
      ecum_q[jr] = v[3 * kTW + r0 + 8 * jr];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= ecum_q[(i >> 1) & 1];
    const float decay = v[4 * kTW];
#pragma unroll
    for (int i = 0; i < 64; ++i) hacc[i] *= decay;

    // M' = (C B^T) o L o dt_t as bf16 hi + lo A fragments: key step kk,
    // register mm holds row r0 + 8 (mm & 1), columns t, t + 1
    uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int i = 8 * kk + 2 * mm;
        const int jr = mm & 1;
        const int q = r0 + 8 * jr;
        const int t = 16 * kk + 8 * (mm >> 1) + cq;
        const float m0 = t <= q ? sc[i] * expf(cum_q[jr] - v[t]) * v[kTW + t] : 0.f;
        const float m1 = t + 1 <= q ? sc[i + 1] * expf(cum_q[jr] - v[t + 1]) * v[kTW + t + 1] : 0.f;
        split_bf16(m0, m1, mhi[kk][mm], mlo[kk][mm]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n64_tb(yacc, mhi[kk], smem_desc(xs(s) + kk * 16 * 128, kBox, 1024, 1));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n64_tb(yacc, mlo[kk], smem_desc(xs(s) + kk * 16 * 128, kBox, 1024, 1));
    wgmma_commit();

    // (x o wt dt)^T as bf16 hi + lo A fragments: rows p, columns t
    const unsigned char* xt = gbase + kXs + s * kBox;
    uint32_t xhi[4][4], xlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int p = r0 + 8 * (mm & 1);
        const int t = 16 * kk + 8 * (mm >> 1) + cq;
        const float x0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xt + sw128(t, p)));
        const float x1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xt + sw128(t + 1, p)));
        split_bf16(x0 * v[2 * kTW + t], x1 * v[2 * kTW + t + 1], xhi[kk][mm], xlo[kk][mm]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n128_tb(hacc, xhi[kk], smem_desc(bs(s) + kk * 16 * 128, kBox, 1024, 1));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_m64n128_tb(hacc, xlo[kk], smem_desc(bs(s) + kk * 16 * 128, kBox, 1024, 1));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(yacc);
    fence_regs<64>(hacc);

    const int s0 = j * kTW;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jr = 0; jr < 2; ++jr) {
        const int q = s0 + r0 + 8 * jr;
        const int p = 8 * i + cq;
        if (q < S && p < P)
          *reinterpret_cast<float2*>(y + (((size_t)b * S + q) * H + h) * P + p) =
              make_float2(yacc[4 * i + 2 * jr], yacc[4 * i + 2 * jr + 1]);
      }
    if (j + 1 < n_tiles) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          const uint32_t off = sw128(r0 + 8 * jr, 8 * i + cq);
          uint32_t hi, lo;
          split_bf16(hacc[4 * i + 2 * jr], hacc[4 * i + 2 * jr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(gbase + kHhi + off) = hi;
          *reinterpret_cast<uint32_t*>(gbase + kHlo + off) = lo;
        }
      fence_async_smem();
      if (warp == 0) {
        scan(vals + (s ^ 1) * kArr);
        fetch(j + 2);
      }
    }
    __syncthreads();                     // stage s, h tiles and values ready
  }

  float* hb = h_last + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      const int p = r0 + 8 * jr;
      const int n = 8 * i + cq;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(hb + (size_t)p * N + n) =
            make_float2(hacc[4 * i + 2 * jr], hacc[4 * i + 2 * jr + 1]);
    }
}

cudaError_t launch_wgmma(const void* x, const void* B, const void* C,
                         const float* dt, const float* da, float* y,
                         float* h_last, int b, int S, int H, int P, int G,
                         int N, cudaStream_t stream) {
  alignas(64) CUtensorMap tx, tb, tc;
  const long long sx[3] = {(long long)S * H * P, (long long)H * P, P};
  const long long sb[3] = {(long long)S * G * N, (long long)G * N, N};
  if (!encode_map(&tx, x, b, S, H, P, sx, 64) ||
      !encode_map(&tb, B, b, S, G, N, sb, 64) ||
      !encode_map(&tc, C, b, S, G, N, sb, 64))
    return cudaErrorInvalidValue;
  // once per process; the carveout lets two blocks share an SM
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemW);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_wgmma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  ssd_wgmma_kernel<<<dim3(H, b), 128, kSmemW, stream>>>(
      tx, tb, tc, dt, da, y, h_last, S, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (b, S, H, P) and B, C (b, S, G, N) in `dtype`; dt, da (b, S, H) f32;
// y (b, S, H, P) and h_last (b, H, P, N) f32; all contiguous.  f32 takes
// N <= 128; bf16 takes P <= 64 and N <= 128, multiples of 16, and 16-byte
// aligned bases (TMA).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dt, const void* da, void* y,
                               void* h_last, int b, int S, int H, int P,
                               int G, int N, int dtype, void* stream) {
  using namespace repro;
  if (b == 0 || H == 0 || P == 0) return 0;
  if (N <= 0 || G <= 0 || H % G != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0)                               // no tokens: the state stays 0
    return (int)cudaMemsetAsync(h_last, 0, sizeof(float) * b * H * P * N, s);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  if (dtype == kF32 && N <= kMaxN)
    return (int)launch_f32(x, B, C, dtf, daf, yf, hf, b, S, H, P, G, N, s);
  if (dtype == kBF16 && P <= kPW && N <= kNW && P % 16 == 0 && N % 16 == 0)
    return (int)launch_wgmma(x, B, C, dtf, daf, yf, hf, b, S, H, P, G, N, s);
  return (int)cudaErrorInvalidValue;
}
