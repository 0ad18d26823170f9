// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention/kernel.py (body `_kernel`, wrapper
// `ops.paged_decode_attention`): one new token per row attends its cached
// keys and values, read from (num_blocks, bs, KV, d) pools through a per-row
// block table.
//
// What bounds it on the H100: memory, and at the decode step's size the
// latency of one launch.  Each row reads ctx * KV * d keys and as many
// values once and does 4 flops per element read, far below the ~295 flops
// per byte where the tensor cores become the limit; at qwen2's decode step
// (8 rows, ~300 tokens of context) that is under 1 MB, 0.26 us at 3.35 TB/s,
// far below the few microseconds one launch takes.  So the design spends
// nothing on tensor cores and keeps the call to one launch and a short
// chain of dependent steps:
//   * one launch, split over the context (flash-decoding): block (row, kv
//     head, split) walks kSplitTok tokens.  The grid is sized from the table
//     width, but a block whose first token is at or past the row's context
//     exits at once, so only ceil(ctx / kSplitTok) splits of a row work.
//     Each writes a partial (max, sum, accumulator) and takes a ticket (an
//     atomic on an int32 counter per (row, kv head)); the last of the live
//     splits to finish merges them, over those splits only, and resets the
//     counter to 0 for the next call.  A row with one live split writes its
//     output directly.  (A thread-block cluster would bound the splits at
//     8 or 16; the ticket takes any context.)
//   * the pool is read where it lies: the block reads its own block-table
//     entries (together with the context, before it is known) and copies
//     token rows of live pages (entry >= 0, position < ctx) with 16-byte
//     cp.async into shared memory, in two stages of kStageTok tokens that
//     are both in flight from the start, one barrier per stage: the second
//     stage's copy runs under the first stage's math.  Rows that are not
//     live arrive as zeros (cp.async with no source bytes) and are masked;
//   * each token row is read by a group of lanes, 16 bytes a lane (32 in
//     f32 at d = 256, where a row of 64 copies would pass a warp), so a
//     dot product is a few FMAs a lane and log2(group) shuffles; every lane
//     group keeps its own online softmax (max, sum, accumulator) in f32
//     registers, and the groups, then the warps, merge at the end of the
//     split;
//   * the rep query heads that share a kv head (up to kRep of them per
//     block) share each staged key and value.  Any rep works (qwen2: 7);
//     more than kRep heads take more blocks.  All kRep heads are computed
//     (those past rep on zeros, never stored), so the heads' chains of
//     shuffles and exponentials interleave;
//   * the last live split merges with every split's loads in flight: a
//     thread takes 4 columns of a head and loads the (max, sum) and the
//     accumulator of up to 16 splits at once.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageTok = 32;        // tokens per stage
constexpr int kSplitTok = 64;        // tokens per split (ops.py: TOKENS_PER_SPLIT)
constexpr int kRep = 8;              // query heads per block

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of a staged row as floats
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __low2float(h[i]);
    o[2 * i + 1] = __high2float(h[i]);
  }
}

// the online-softmax merge of (m2, l2) into (m, l): the factors that scale
// the two accumulators
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2, float l2,
                                         float& a1, float& a2) {
  const float m_new = fmaxf(m, m2);
  const float m_safe = fmaxf(m_new, kMaxClamp);
  a1 = expf(fmaxf(m, kMaxClamp) - m_safe);
  a2 = expf(fmaxf(m2, kMaxClamp) - m_safe);
  l = l * a1 + l2 * a2;
  m = m_new;
}

// D: the instance's head dim (32, 64, 128, 256); a smaller d runs with the
// lanes past it idle.  A token row is CPR copies of 16 bytes (E elements
// each).  It is read by LT <= 32 lanes, V vectors of 16 bytes a lane (V = 2
// only for f32 at D = 256, whose 64 copies would not fit a warp otherwise),
// EL elements a lane; a warp pass reads TPW token rows.
template <typename TQ, typename TKV, int D>
struct Geo {
  static constexpr int E = 16 / sizeof(TKV);
  static constexpr int CPR = D / E;                      // 16-byte copies per row
  static constexpr int V = CPR > 32 ? CPR / 32 : 1;      // vectors per lane
  static constexpr int LT = CPR / V;                     // lanes per token row
  static constexpr int EL = E * V;                       // elements per lane
  static constexpr int TPW = 32 / LT;                    // token rows per warp pass
  static constexpr int kStageElems = kStageTok * D;      // of K (and of V)
  static constexpr size_t kSmem = 2 * 2 * kStageElems * sizeof(TKV) +  // K, V x 2 stages
                                  2 * kStageTok * sizeof(int) +        // live flags
                                  kWarps * kRep * (D + 2) * sizeof(float) + 16;
  static_assert(LT <= 32 && 32 % LT == 0, "a token row must fit one warp");
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,              // (B, H, d)
    const TKV* __restrict__ k_pool,        // (num_blocks, bs, KV, d)
    const TKV* __restrict__ v_pool,        // (num_blocks, bs, KV, d)
    const int32_t* __restrict__ table,     // (B, max_blk), -1 = unmapped
    const int32_t* __restrict__ ctx_len,   // (B,)
    TQ* __restrict__ out,                  // (B, H, d)
    int* __restrict__ counter,             // (B, KV * n_hg), all 0 between calls
    float* __restrict__ part_ml,           // (B, KV * n_hg, n_split, kRep, 2)
    float* __restrict__ part_acc,          // (B, KV * n_hg, n_split, kRep, d)
    int H, int KV, int d, int bs, int max_blk, float scale) {
  using G = Geo<TQ, TKV, D>;
  constexpr int E = G::E, CPR = G::CPR, V = G::V, LT = G::LT, EL = G::EL, TPW = G::TPW;
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* k_s = reinterpret_cast<TKV*>(smem);                 // [stage][token][D]
  TKV* v_s = k_s + 2 * G::kStageElems;
  int* live_s = reinterpret_cast<int*>(v_s + 2 * G::kStageElems);   // [stage][token]
  float* wacc_s = reinterpret_cast<float*>(live_s + 2 * kStageTok); // [warp][r][D]
  float* wml_s = wacc_s + kWarps * kRep * D;                        // [warp][r][2]
  __shared__ int last_s;

  const int b = blockIdx.x;
  const int gh = blockIdx.y;               // (kv head, group of kRep heads)
  const int s = blockIdx.z;
  const int rep = H / KV;
  const int n_hg = (rep + kRep - 1) / kRep;
  const int g = gh / n_hg;
  const int h0 = g * rep + (gh % n_hg) * kRep;   // first query head of the block
  const int nh = min(kRep, g * rep + rep - h0);
  const int n_split = gridDim.z;

  // this thread's token rows of both stages (copies e = tid + k kThreads
  // of a stage, CPR copies a row): their table entries are read together
  // with the context, before it is known
  constexpr int kRows = kStageTok * CPR / kThreads;
  const int tid = threadIdx.x;
  const int t0 = s * kSplitTok;
  const int32_t* tb = table + (size_t)b * max_blk;
  int blk[2][kRows];
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int pos = t0 + st * kStageTok + (tid + k * kThreads) / CPR;
      blk[st][k] = pos < max_blk * bs ? tb[pos / bs] : -1;
    }
  const int ctx = ctx_len[b];
  const int limit = min(max(ctx, 0), max_blk * bs);    // positions that can be live
  const int n_live = (limit + kSplitTok - 1) / kSplitTok;
  if (s >= max(n_live, 1)) return;
  TQ* ob = out + ((size_t)b * H + h0) * d;
  if (n_live == 0) {                       // no context: the row is 0
    for (int e = tid; e < nh * d; e += kThreads) store(ob + e, 0.f);
    return;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi = lane / LT;                // this lane's token row in a pass
  const int c = lane % LT;                 // and its EL columns from c * EL
  const int n_stages = min(kSplitTok / kStageTok, (limit - t0 + kStageTok - 1) / kStageTok);
  const size_t tok_stride = (size_t)KV * d;

  // copies of stage st: token rows of live positions, zeros elsewhere
  auto issue = [&](int st) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int e = tid + k * kThreads;
      const int t = e / CPR;
      const int cc = e % CPR;
      const int pos = t0 + st * kStageTok + t;
      const int bk = blk[st][k];
      const bool live = pos < limit && bk >= 0;
      if (cc == 0) live_s[st * kStageTok + t] = live;
      const bool ok = live && cc * E < d;
      const size_t src = ok ? ((size_t)bk * bs + pos % bs) * tok_stride + (size_t)g * d + cc * E : 0;
      const int dst = st * G::kStageElems + t * D + cc * E;
      cp_async16(k_s + dst, k_pool + src, ok ? 16 : 0);
      cp_async16(v_s + dst, v_pool + src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // both stages of the split in flight at once
  issue(0);
  if (n_stages > 1) issue(1);

  // this lane's columns of the block's query heads, pre-scaled, in f32;
  // heads past nh compute on zeros and are never stored, so every head's
  // chain of shuffles and exponentials interleaves with the others'
  float qv[kRep][EL];
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int e = 0; e < EL; ++e)
      qv[r][e] = (r < nh && c * EL + e < d)
                     ? to_f32(q[((size_t)b * H + h0 + r) * d + c * EL + e]) * scale : 0.f;
  float m[kRep], l[kRep], acc[kRep][EL];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[r][e] = 0.f;
  }

  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) cp_async_wait_one();
    else cp_async_wait_all();
    __syncthreads();                       // stage st landed for every thread
#pragma unroll
    for (int pass = 0; pass < kStageTok / (kWarps * TPW); ++pass) {
      const int t = pass * kWarps * TPW + warp * TPW + gi;
      float kf[EL], vf[EL];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        load16(k_s + st * G::kStageElems + t * D + c * EL + u * E, kf + u * E);
        load16(v_s + st * G::kStageElems + t * D + c * EL + u * E, vf + u * E);
      }
      const bool live = live_s[st * kStageTok + t];
      float dot[kRep];
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        dot[r] = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) dot[r] += qv[r][e] * kf[e];
      }
#pragma unroll
      for (int o = LT / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kRep; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        const float sc = live ? dot[r] : kNeg;
        const float m_new = fmaxf(m[r], sc);
        const float m_safe = fmaxf(m_new, kMaxClamp);
        const float alpha = expf(fmaxf(m[r], kMaxClamp) - m_safe);
        const float p = expf(sc - m_safe);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[r][e] = acc[r][e] * alpha + p * vf[e];
        m[r] = m_new;
      }
    }
  }

  // merge the lane groups of each warp, then the warps
#pragma unroll
  for (int o = LT; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      float a1, a2;
      merge_ml(m[r], l[r], m2, l2, a1, a2);
#pragma unroll
      for (int e = 0; e < EL; ++e)
        acc[r][e] = acc[r][e] * a1 + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * a2;
    }
  }
  if (gi == 0) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      if (r >= nh) continue;
#pragma unroll
      for (int e = 0; e < EL; ++e) wacc_s[(warp * kRep + r) * D + c * EL + e] = acc[r][e];
      if (c == 0) {
        wml_s[(warp * kRep + r) * 2] = m[r];
        wml_s[(warp * kRep + r) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();

  const size_t part = (((size_t)b * gridDim.y + gh) * n_split + s) * kRep;
  for (int e = tid; e < nh * d; e += kThreads) {
    const int r = e / d;
    const int dd = e - r * d;
    float mm = kNeg, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float a1, a2;
      merge_ml(mm, ll, wml_s[(w * kRep + r) * 2], wml_s[(w * kRep + r) * 2 + 1], a1, a2);
      aa = aa * a1 + wacc_s[(w * kRep + r) * D + dd] * a2;
    }
    if (n_live == 1) {
      store(ob + e, aa / fmaxf(ll, kDenomFloor));
    } else {
      part_acc[(part + r) * d + dd] = aa;
      if (dd == 0) {
        part_ml[(part + r) * 2] = mm;
        part_ml[(part + r) * 2 + 1] = ll;
      }
    }
  }
  if (n_live == 1) return;

  // ticket: the last live split of (row, kv head group) merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + (size_t)b * gridDim.y + gh;
    const int ticket = atomicAdd(cnt, 1);
    last_s = ticket == n_live - 1;
    if (last_s) *cnt = 0;                  // every live split has counted
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // each thread merges 4 columns of one head over every live split: its
  // (max, sum) pairs and accumulators for up to kMergeChunk splits are
  // loaded together, one trip to L2 a chunk
  constexpr int kMergeChunk = 16;
  const size_t first = ((size_t)b * gridDim.y + gh) * n_split * kRep;
  for (int e = 4 * tid; e < nh * d; e += 4 * kThreads) {
    const int r = e / d;
    const float2* ml2 = reinterpret_cast<const float2*>(part_ml) + first + r;
    const float4* acc4 = reinterpret_cast<const float4*>(part_acc + (first + r) * d + (e - r * d));
    const size_t acc_stride = (size_t)kRep * d / 4;      // float4s from split to split
    float mm = kNeg, ll = 0.f;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n_live; c0 += kMergeChunk) {
      float2 pm[kMergeChunk];
      float4 pa[kMergeChunk];
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i)
        if (c0 + i < n_live) {
          pm[i] = __ldcg(ml2 + (size_t)(c0 + i) * kRep);
          pa[i] = __ldcg(acc4 + (size_t)(c0 + i) * acc_stride);
        }
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i)
        if (c0 + i < n_live) {
          float a1, a2;
          merge_ml(mm, ll, pm[i].x, pm[i].y, a1, a2);
          aa = make_float4(aa.x * a1 + pa[i].x * a2, aa.y * a1 + pa[i].y * a2,
                           aa.z * a1 + pa[i].z * a2, aa.w * a1 + pa[i].w * a2);
        }
    }
    const float den = fmaxf(ll, kDenomFloor);
    store(ob + e, aa.x / den);
    store(ob + e + 1, aa.y / den);
    store(ob + e + 2, aa.z / den);
    store(ob + e + 3, aa.w / den);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* ctx_len, void* out,
                   int* counter, float* part_ml, float* part_acc, int B, int H,
                   int KV, int d, int bs, int max_blk, int n_split, float scale,
                   cudaStream_t stream) {
  using G = Geo<TQ, TKV, D>;
  auto kern = paged_decode_kernel<TQ, TKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (attr != cudaSuccess) return attr;
  const int n_hg = (H / KV + kRep - 1) / kRep;
  kern<<<dim3(B, KV * n_hg, n_split), kThreads, G::kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(ctx_len), static_cast<TQ*>(out), counter,
      part_ml, part_acc, H, KV, d, bs, max_blk, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const void* q, const void* kp, const void* vp, const void* table,
                     const void* ctx, void* out, int* counter, float* ml, float* acc,
                     int B, int H, int KV, int d, int bs, int max_blk, int n_split,
                     float scale, cudaStream_t s) {
  if (d <= 32)
    return launch<TQ, TKV, 32>(q, kp, vp, table, ctx, out, counter, ml, acc, B, H, KV, d, bs, max_blk, n_split, scale, s);
  if (d <= 64)
    return launch<TQ, TKV, 64>(q, kp, vp, table, ctx, out, counter, ml, acc, B, H, KV, d, bs, max_blk, n_split, scale, s);
  if (d <= 128)
    return launch<TQ, TKV, 128>(q, kp, vp, table, ctx, out, counter, ml, acc, B, H, KV, d, bs, max_blk, n_split, scale, s);
  return launch<TQ, TKV, 256>(q, kp, vp, table, ctx, out, counter, ml, acc, B, H, KV, d, bs, max_blk, n_split, scale, s);
}

}  // namespace
}  // namespace repro

// Scratch, one allocation: `counter` B * KV * n_hg int32 that are 0 before
// the first call (each call leaves them 0), `part_ml` and `part_acc` f32 of
// B * KV * n_hg * n_split * 8 * 2 and * d, where n_hg = ceil((H / KV) / 8)
// and n_split = ceil(max_blk * bs / 64).  d <= 256 and the pool's rows of
// 16 bytes' multiple (d % 8 in bf16, d % 4 in f32), 16-byte aligned pools.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* ctx_len, void* out, void* counter, void* part_ml,
    void* part_acc, int B, int H, int KV, int d, int bs, int max_blk,
    int n_split, float scale, int q_dtype, int kv_dtype, void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  const int kv_size = kv_dtype == kF32 ? 4 : 2;
  if (H % KV != 0 || d > 256 || (d * kv_size) % 16 != 0 ||
      n_split * kSplitTok < max_blk * bs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counter);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
#define REPRO_PAGED(TQ, TKV) \
  launch_d<TQ, TKV>(q, k_pool, v_pool, table, ctx_len, out, cnt, ml, acc, B, H, KV, d, bs, max_blk, n_split, scale, s)
  cudaError_t err;
  if (q_dtype == kF32 && kv_dtype == kF32) err = REPRO_PAGED(float, float);
  else if (q_dtype == kF32 && kv_dtype == kBF16) err = REPRO_PAGED(float, __nv_bfloat16);
  else if (q_dtype == kBF16 && kv_dtype == kF32) err = REPRO_PAGED(__nv_bfloat16, float);
  else if (q_dtype == kBF16 && kv_dtype == kBF16) err = REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
  else err = cudaErrorInvalidValue;
#undef REPRO_PAGED
  return (int)err;
}
