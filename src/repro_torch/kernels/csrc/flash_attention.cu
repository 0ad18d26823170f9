// Causal (optionally windowed) flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_attn_kernel`, wrapper
// `ops.attention`): FA2-style attention with an online softmax over key
// tiles, GQA (query head h reads kv head h / rep), sliding windows, and
// queries right-aligned against the keys when Skv > Sq.  q is read as
// (B, Sq, H, d) and k, v as (B, Skv, KV, d) in place through their strides;
// rows past Sq and keys past Skv are masked here, nothing is padded.
//
// Two kernels, chosen by dtype alone.
//
// bf16: `flash_wgmma_kernel<D>`, D in {32, 64, 128, 256}; a head dim d that
// is a multiple of 16 runs in the smallest D >= d, TMA filling columns d..D
// with zeros.  What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s), at qwen2's
// heads (14 over 2, d = 64):
//   * the serving engine's bucketed prefill, B = 4, S = 128: bytes, 2.1 MB
//     against 118 MFLOP, 0.6 us.  That is far below one launch, so the call
//     is bound by latency: one tile's trip into an SM and out;
//   * a full batch of long prompts, B = 8, S = 1024: operations, 15 GFLOP in
//     15 us, against 34 MB in 10 us.
// The design:
//   * one block per (query head, row, 64-query tile), the tiles with the most
//     keys launched first; its one warpgroup (128 threads) owns the 64 query
//     rows, so that small prompts still spread over the SMs;
//   * Q and a ring of two K/V stages stay in bf16 in shared memory, filled by
//     TMA (one 4-d tensor map per operand, built on the host from pointer,
//     shape and strides; mbarrier completion) in the 128-byte (64-byte at
//     D = 32) swizzle that the wgmma descriptors name.  Thread 0 issues the
//     copy of key tile j + 1 before the math of tile j.  Rows, keys and
//     columns out of range arrive as zeros;
//   * S = Q K^T is D / 16 `wgmma.m64n64k16` steps, bf16 in, f32 out in
//     registers.  Whole key tiles that the causal mask or the window hides
//     are skipped; only tiles that cross the diagonal, the window edge or
//     Skv are masked;
//   * the online softmax stays in registers: a query row's 64 scores lie on
//     the 4 lanes of a quad, so its max takes 2 shuffles; m and l are f32
//     with the reference's clamps;
//   * P is rounded to bf16 in registers and is wgmma's A operand as it lies
//     (the accumulator fragment of S is the A fragment of P V); V is the B
//     operand from shared memory, [key][d], with the transpose flag:
//     `wgmma.m64n{D}k16`, f32 accumulators, O rescaled in registers;
//   * l sums P after its rounding to bf16, the very weights that P V uses, so
//     the output is a convex combination of V rows up to f32 rounding; each
//     lane sums its own columns and the quad's sums meet once, at the end;
//   * the epilogue writes O / max(l, 1e-30) as bf16 to shared memory and
//     stores 16-byte rows to (B, Sq, H, d);
//   * D = 256 (gemma's heads) takes two warpgroups.  One warpgroup would hold
//     a 64 x 256 f32 accumulator, 128 registers a thread beside S (32) and P
//     (16), near the cap of 255.  Each of the two computes the same S and P
//     (Q K^T twice, 1.5x the minimal tensor work) and its own 128 columns of
//     O from its half of the V tile; shared memory is Q and two K/V stages,
//     5 x 32 KB.
//
// f32: `flash_f32_kernel<BQ>`, on the CUDA cores, which holds the reference's
// 2e-5 bar (TF32 tensor cores keep about 1e-3).  It serves the f32 logits
// check and the tests, not the bf16 serving path: one warp owns a query row
// at a time, a lane scores two keys and updates d / 32 output dims, with
// q, k, v and the accumulator in f32 shared memory; BQ = 64 query rows a
// block up to d = 128 and 32 above, where 64 rows would not fit.

#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;       // query rows per block (f32 at d > 128: 32)
constexpr int kBK = 64;       // keys per tile
constexpr int kMaxD = 256;
constexpr int kStages = 2;    // K/V tiles in flight (bf16 kernel)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- f32

constexpr int kF32Warps = 4;

// K (padded rows), V, then BQ rows of Q and of the accumulator: 263,936 B at
// BQ = 64 and d = 256, over the 232,448 a block may have, so d > 128 takes
// BQ = 32 (198,144 B)
size_t f32_smem(int bq, int d) {
  return sizeof(float) * ((size_t)kBK * (d + 1) + (size_t)kBK * d +
                          2 * (size_t)bq * d + 2 * bq + kF32Warps * kBK);
}

template <int BQ>
__global__ void __launch_bounds__(kF32Warps * 32) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,  // (B, Sq, H, d)
    int Sq, int Skv, int H, int KV, int d,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int dk = d + 1;                  // padded key rows: no bank conflicts
  float* k_s = smem;                     // kBK * dk
  float* v_s = k_s + kBK * dk;           // kBK * d
  float* q_s = v_s + kBK * d;            // BQ * d, pre-scaled
  float* acc_s = q_s + BQ * d;           // BQ * d
  float* m_s = acc_s + BQ * d;           // BQ
  float* l_s = m_s + BQ;                 // BQ
  float* p_s = l_s + BQ;                 // kF32Warps * kBK

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int q_lo = blockIdx.x * BQ;
  const int n_rows = min(BQ, Sq - q_lo);
  const int off = Skv - Sq;              // absolute position of query row 0

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + g * ksh;
  const float* vb = v + b * vsb + g * vsh;

  for (int e = tid; e < BQ * d; e += blockDim.x) {
    const int r = e / d;
    const int dd = e - r * d;
    q_s[e] = r < n_rows ? qb[(q_lo + r) * qss + dd] * scale : 0.f;
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < BQ; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  // keys any row of this tile can see
  const int qa_lo = q_lo + off;
  const int qa_hi = q_lo + n_rows - 1 + off;
  const int k_end = causal ? min(Skv, qa_hi + 1) : Skv;
  const int k_begin = window ? max(0, qa_lo - window + 1) : 0;

  float* p_w = p_s + warp * kBK;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                     // previous tile fully consumed
    for (int e = tid; e < kBK * d; e += blockDim.x) {
      const int t = e / d;
      const int dd = e - t * d;
      const int key = k0 + t;
      const bool ok = key < Skv;
      k_s[t * dk + dd] = ok ? kb[key * kss + dd] : 0.f;
      v_s[t * d + dd] = ok ? vb[key * vss + dd] : 0.f;
    }
    __syncthreads();

    for (int rr = warp; rr < n_rows; rr += kF32Warps) {
      const int qa = q_lo + rr + off;
      const float* qr = q_s + rr * d;
      float s[kBK / 32];
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int t = lane + 32 * i;
        const int key = k0 + t;
        bool ok = key < Skv;
        if (causal) ok = ok && key <= qa;
        if (window) ok = ok && key > qa - window;
        const float* kr = k_s + t * dk;
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd) dot += qr[dd] * kr[dd];
        s[i] = ok ? dot : kNeg;
      }
      float mx = s[0];
#pragma unroll
      for (int i = 1; i < kBK / 32; ++i) mx = fmaxf(mx, s[i]);
      mx = warp_max(mx);
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, kMaxClamp);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const float p = expf(s[i] - m_safe);
        p_w[lane + 32 * i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(fmaxf(m_prev, kMaxClamp) - m_safe);
      __syncwarp();
      float* ar = acc_s + rr * d;
      for (int dd = lane; dd < d; dd += 32) {
        float a = ar[dd] * alpha;
        for (int t = 0; t < kBK; ++t) a += p_w[t] * v_s[t * d + dd];
        ar[dd] = a;
      }
      if (lane == 0) {
        l_s[rr] = l_s[rr] * alpha + sum;
        m_s[rr] = m_new;
      }
      __syncwarp();                      // p_w and m_s reused by the next row
    }
  }
  __syncthreads();

  float* ob = out + (((size_t)b * Sq + q_lo) * H + h) * d;
  for (int e = tid; e < n_rows * d; e += blockDim.x) {
    const int r = e / d;
    const int dd = e - r * d;
    ob[(size_t)r * H * d + dd] = acc_s[e] / fmaxf(l_s[r], kDenomFloor);
  }
}

template <int BQ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Skv, int H, int KV, int d,
                       const long long* st, float scale, int causal,
                       int window, cudaStream_t stream) {
  // once per process: the largest request of the instance, that of its
  // largest d (128 at BQ = 64, kMaxD at BQ = 32)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_smem(BQ, BQ == kBQ ? 128 : kMaxD));
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_f32_kernel<BQ><<<grid, kF32Warps * 32, f32_smem(BQ, d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KV,
      d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t b) {
  if constexpr (D == 32) wgmma_rs_m64n32_tb(o, a, b);
  else if constexpr (D == 64) wgmma_rs_m64n64_tb(o, a, b);
  else wgmma_rs_m64n128_tb(o, a, b);
}

template <int D>
struct Tiles {
  // consumer warpgroups: at D = 256 two, each computing the same S and P
  // and its own half of O's columns, so a thread holds 64 accumulators, not
  // 128 beside S and P (Q K^T is computed twice)
  static constexpr int kWG = D > 128 ? 2 : 1;
  static constexpr int kDW = D / kWG;                   // O columns per warpgroup
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kSwE = D < 64 ? D : 64;          // elements per swizzled row
  static constexpr int kSwB = 2 * kSwE;                 // its bytes: 64 or 128
  static constexpr int kChunks = D / kSwE;              // TMA boxes per tile
  static constexpr int kChunkBytes = kBQ * kSwB;        // one box: 64 rows
  static constexpr int kTile = kBQ * D * 2;             // Q, K or V tile, bf16
  static constexpr uint64_t kLayout = kSwB == 128 ? 1 : 2;
  // Q, then K and V of each stage, then the mbarriers; 1 KB of slack to
  // align the tiles to the swizzle's 1024-byte period
  static constexpr size_t kSmem = (1 + 2 * kStages) * (size_t)kTile + 8 * (1 + kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    __nv_bfloat16* __restrict__ out,       // (B, Sq, H, d) contiguous
    int Sq, int Skv, int H, int KV, int d, float scale, int causal,
    int window) {
  using T = Tiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + (1 + 2 * kStages) * T::kTile;
  auto k_s = [&](int s) { return base + T::kTile * (1 + 2 * s); };
  auto v_s = [&](int s) { return base + T::kTile * (2 + 2 * s); };
  auto bar_kv = [&](int s) { return bar_q + 8 * (1 + s); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;         // within its warpgroup: 16 rows
  const int wg = tid >> 7;                 // warpgroup: O columns wg * kDW ..
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / KV);
  // the last query tiles see the most keys under the causal mask: they go
  // first, for every head and row, and the short ones fill the tail
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int n_rows = min(kBQ, Sq - q_lo);
  const int qa_lo = q_lo + Skv - Sq;     // absolute position of the tile's row 0
  const int qa_hi = qa_lo + n_rows - 1;

  // key tiles any row of this tile can see
  const int k_end = causal ? min(Skv, qa_hi + 1) : Skv;
  const int t_begin = (window ? max(0, qa_lo - window + 1) : 0) / kBK;
  const int n_tiles = max(0, (k_end + kBK - 1) / kBK - t_begin);

  auto load_kv = [&](int s, int t) {
    mbar_expect_tx(bar_kv(s), 2 * T::kTile);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
      tma_load(k_s(s) + c * T::kChunkBytes, &tm_k, bar_kv(s), c * T::kSwE, g, t * kBK, b);
      tma_load(v_s(s) + c * T::kChunkBytes, &tm_v, bar_kv(s), c * T::kSwE, g, t * kBK, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, T::kTile);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(q_s + c * T::kChunkBytes, &tm_q, bar_q, c * T::kSwE, h, q_lo, b);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv(j, t_begin + j);
  }

  // accumulator fragment: this thread holds rows r0 and r0 + 8 of the tile,
  // columns 8 i + cq and 8 i + cq + 1 of every 8-column block i
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  constexpr int kO = T::kDW / 2;           // accumulators a thread
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};                 // this lane's share of the row sums

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int jn = j + kStages - 1;        // the tile whose copy starts now
    if (tid == 0 && jn < n_tiles) load_kv(jn % kStages, t_begin + jn);
    mbar_wait(bar_kv(s), (j / kStages) & 1);
    const int k0 = (t_begin + j) * kBK;

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t koff = (ks * 16 / T::kSwE) * T::kChunkBytes + (ks * 16 % T::kSwE) * 2;
      wgmma_ss_m64n64(sc, smem_desc(q_s + koff, 16, 8 * T::kSwB, T::kLayout),
                      smem_desc(k_s(s) + koff, 16, 8 * T::kSwB, T::kLayout), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

    // scale, mask where the tile crosses the diagonal, the window or Skv
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > qa_lo) ||
                      (window && k0 <= qa_hi - window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int jr = (i >> 1) & 1;
      float t = sc[i] * scale;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qa = qa_lo + r0 + 8 * jr;
        bool ok = key < Skv;
        if (causal) ok = ok && key <= qa;
        if (window) ok = ok && key > qa - window;
        t = ok ? t : kNeg;
      }
      sc[i] = t;
      mx[jr] = fmaxf(mx[jr], t);
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      mx[jr] = fmaxf(mx[jr], __shfl_xor_sync(0xffffffffu, mx[jr], 1));
      mx[jr] = fmaxf(mx[jr], __shfl_xor_sync(0xffffffffu, mx[jr], 2));
      const float m_new = fmaxf(m[jr], mx[jr]);
      m_safe[jr] = fmaxf(m_new, kMaxClamp);
      alpha[jr] = exp2f((fmaxf(m[jr], kMaxClamp) - m_safe[jr]) * kLog2e);
      m[jr] = m_new;
      l[jr] *= alpha[jr];
    }

    // P in bf16, laid out as wgmma's A fragment: key step kk, register mm
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int i = 8 * kk + 2 * mm;
        const int jr = mm & 1;
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            exp2f((sc[i] - m_safe[jr]) * kLog2e),
            exp2f((sc[i + 1] - m_safe[jr]) * kLog2e));
        l[jr] += __low2float(p) + __high2float(p);
        pa[kk][mm] = *reinterpret_cast<const uint32_t*>(&p);
      }
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V, this warpgroup's columns of V
    const uint32_t v_cols = v_s(s) + wg * (T::kDW / T::kSwE) * T::kChunkBytes;
    fence_regs<kO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<T::kDW>(o, pa[kk], smem_desc(v_cols + kk * 16 * T::kSwB,
                                            T::kChunkBytes, 8 * T::kSwB, T::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kO>(o);
    __syncthreads();                       // stage s is free for tile j + kStages
  }

  // epilogue: O / max(l, floor) in bf16 through shared memory (the stage-0
  // K and V tiles, no longer read), then 16-byte rows to global memory
  float den[2];
#pragma unroll
  for (int jr = 0; jr < 2; ++jr) {
    l[jr] += __shfl_xor_sync(0xffffffffu, l[jr], 1);
    l[jr] += __shfl_xor_sync(0xffffffffu, l[jr], 2);
    den[jr] = fmaxf(l[jr], kDenomFloor);
  }
  constexpr int kPitch = D + 8;            // elements; 16-byte rows, few bank conflicts
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (k_s(0) - raw)) + wg * T::kDW;
#pragma unroll
  for (int i = 0; i < T::kDW / 8; ++i)
#pragma unroll
    for (int jr = 0; jr < 2; ++jr)
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * jr) * kPitch + 8 * i + cq) =
          __floats2bfloat162_rn(o[4 * i + 2 * jr] / den[jr], o[4 * i + 2 * jr + 1] / den[jr]);
  __syncthreads();
  stage -= wg * T::kDW;
  const int per_row = d / 8;               // 16-byte pieces of a row of d
  __nv_bfloat16* ob = out + (((size_t)b * Sq + q_lo) * H + h) * d;
  for (int e = tid; e < n_rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = e - r * per_row;
    *reinterpret_cast<uint4*>(ob + (size_t)r * H * d + 8 * c) =
        *reinterpret_cast<const uint4*>(stage + r * kPitch + 8 * c);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int KV,
                         int d, const long long* st, float scale, int causal,
                         int window, cudaStream_t stream) {
  using T = Tiles<D>;
  alignas(64) CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, Sq, H, d, st, T::kSwE) ||
      !encode_map(&tk, k, B, Skv, KV, d, st + 3, T::kSwE) ||
      !encode_map(&tv, v, B, Skv, KV, d, st + 6, T::kSwE))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KV, d, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// strides: q (b, s, h), k (b, s, h), v (b, s, h) in elements; the last dim
// is contiguous.  bf16 needs d % 16 == 0, 16-byte aligned bases and strides
// that are multiples of 8 (TMA); f32 takes any d <= 256.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Skv, int H, int KV, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int window, int dtype,
    void* stream) {
  using namespace repro;
  if (B == 0 || Sq == 0) return 0;
  if (d > kMaxD || H % KV != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0)                             // no keys: every row is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * d * (dtype == kF32 ? 4 : 2), s);
  if (dtype == kF32)
    return d <= 128
        ? (int)launch_f32<kBQ>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s)
        : (int)launch_f32<kBQ / 2>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  if (dtype != kBF16 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  if (d <= 32)
    return (int)launch_wgmma<32>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  if (d <= 64)
    return (int)launch_wgmma<64>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  if (d <= 128)
    return (int)launch_wgmma<128>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  return (int)launch_wgmma<256>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
}
