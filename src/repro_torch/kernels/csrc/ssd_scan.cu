// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in
// src/repro/kernels/ssd_scan/kernel.py (body `_kernel`, wrapper
// `ops.ssd_chunked_scan`).  For every (row, head) it computes the
// state-space recurrence over pre-activated inputs
//   h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T     (P x N state, zero at t = 0)
//   y_t = h_t C_t
// in its chunked (state-space dual) form: within a tile of kT tokens
//   M   = (C B^T) o L,   L[q][t] = exp(cum_q - cum_t) for t <= q, else 0
//   y   = M (x dt) + exp(cum) (C h)
//   h'  = exp(cum_last) h + (B wt)^T (x dt),   wt[t] = exp(cum_last - cum_t)
// with cum the running sum of da inside the tile.  The chunked form equals
// the recurrence in exact arithmetic for any tile length, so the tile need
// not be the caller's chunk; only the rounding differs.
//
// What bounds it on the H100: at the serving shapes (H = 48 heads, P = 64,
// N = 128, one group, prompts of a few hundred tokens) the bytes.  x, B, C,
// dt, da are read once and y (f32) and the final state written once: about
// 46 MB at b = 4, S = 512, against some 13 GFLOP of the reference's chunked
// products at its chunk of 256.  The design:
//   * the TPU kernel carried h in VMEM across a sequential grid axis; here
//     one thread block owns a (row, head, kPB-column slice of P) and walks
//     the sequence itself, keeping its slice of h (kPB x N f32) in shared
//     memory from tile to tile.  The y and h columns are independent over
//     P, so slicing P doubles the blocks (2 x 48 x b) at the cost of
//     computing C B^T once per slice;
//   * the tile is kT = 32 tokens, not the reference's 256: a 256 x 256 f32
//     M would not fit in shared memory, and the intra-tile products shrink
//     with the tile while the carried-state products stay the same;
//   * B and C arrive unexpanded, (b, S, G, N): head h reads group
//     h / (H / G), so the model never materialises the H / G copies the
//     JAX wrapper made;
//   * the causal mask is applied before exp (cum_q - cum_t > 0 above the
//     diagonal, where exp may overflow and inf * 0 is NaN);
//   * padded rows of shared-memory tiles (stride N + 1, kT + 1) keep the
//     column walks free of bank conflicts.
// It runs on the CUDA cores in f32, whatever the input type.  Tensor-core
// (wgmma) tiles for the three products are the step that would bring it
// toward its bound.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 32;         // tokens per tile
constexpr int kPB = 32;        // columns of P per block
constexpr int kMaxN = 128;     // state size the register tiles cover
constexpr int kThreads = 256;  // 8 warps

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x,         // (b, S, H, P)
    const T* __restrict__ Bm,        // (b, S, G, N)
    const T* __restrict__ Cm,        // (b, S, G, N)
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
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  const T* bb = Bm + (size_t)b * S * brow + (size_t)g * N;
  const T* cb = Cm + (size_t)b * S * brow + (size_t)g * N;
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
      b_s[t * ns + n] = ok ? to_f32(bb[src]) : 0.f;
      c_s[t * ns + n] = ok ? to_f32(cb[src]) : 0.f;
    }
    for (int e = tid; e < kT * kPB; e += kThreads) {
      const int t = e / kPB;
      const int p = e - t * kPB;
      const bool ok = t < nt && p0 + p < P;
      x_s[e] = ok ? to_f32(xb[(size_t)(s0 + t) * xrow + p0 + p]) *
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

template <typename T>
cudaError_t launch(const void* x, const void* B, const void* C,
                   const float* dt, const float* da, float* y, float* h_last,
                   int b, int S, int H, int P, int G, int N,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kPB * (N + 1) + 2 * (size_t)kT * (N + 1) + (size_t)kT * kPB +
       (size_t)kT * (kT + 1) + 3 * (size_t)kT);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kPB - 1) / kPB, H, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(C), dt, da, y, h_last, S, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (b, S, H, P) and B, C (b, S, G, N) in `dtype`; dt, da (b, S, H) f32;
// y (b, S, H, P) and h_last (b, H, P, N) f32; all contiguous.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dt, const void* da, void* y,
                               void* h_last, int b, int S, int H, int P,
                               int G, int N, int dtype, void* stream) {
  using namespace repro;
  if (b == 0 || H == 0 || P == 0) return 0;
  if (N <= 0 || N > kMaxN || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  if (dtype == kF32)
    return (int)launch<float>(x, B, C, dtf, daf, yf, hf, b, S, H, P, G, N, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(x, B, C, dtf, daf, yf, hf, b, S, H, P, G, N, s);
  return (int)cudaErrorInvalidValue;
}
