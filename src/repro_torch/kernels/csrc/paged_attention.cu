// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention/kernel.py (body `_kernel`, wrapper
// `ops.paged_decode_attention`): one new token per row attends its cached
// keys and values, read from (num_blocks, bs, KV, d) pools through a per-row
// block table.
//
// What bounds it on the H100: memory.  Each row reads ctx * KV * d keys and
// as many values once and does 4 flops per element read (a dot and an
// axpy), far below the ~295 flops per byte where the tensor cores become the
// limit.  So the design spends nothing on tensor cores; it reads each key
// and value once, in place, and spreads the reading over enough blocks:
//   * the pool is read where it lies: a block loads its own block-table
//     entries and copies only live pages (entry >= 0, start < ctx) into
//     shared memory, no transpose or gather of the pool (the TPU wrapper
//     transposed both whole pools every call);
//   * split over the context (flash-decoding): block (row, kv head, split)
//     walks `pages_per_split` pages with an online softmax in f32 and writes
//     a partial (max, sum, accumulator); a second, small kernel merges the
//     splits of each (row, kv head).  A TPU grid step runs in order and can
//     carry the state across pages; here the splits run in parallel, so a
//     long row keeps many SMs busy instead of one;
//   * the `rep` query heads that share a kv head share each staged page:
//     a key and a value are loaded once and used for all of them.  Any rep
//     works (qwen2: 7).
// Pages are staged one at a time without double buffering; overlapping the
// next page's copy with this page's math is the next step.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;

// Partial attention of one (row, kv head) over pages [s * pps, (s+1) * pps).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q,              // (B, H, d)
    const TKV* __restrict__ k_pool,        // (num_blocks, bs, KV, d)
    const TKV* __restrict__ v_pool,        // (num_blocks, bs, KV, d)
    const int32_t* __restrict__ table,     // (B, max_blk), -1 = unmapped
    const int32_t* __restrict__ ctx_len,   // (B,)
    float* __restrict__ part_ml,           // (B, KV, n_split, rep, 2)
    float* __restrict__ part_acc,          // (B, KV, n_split, rep, d)
    int H, int KV, int d, int bs, int max_blk, int pps, int n_split,
    float scale) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int s = blockIdx.z;
  const int dk = d + 1;                  // padded key rows: no bank conflicts
  float* q_s = smem;                     // rep * d, pre-scaled queries
  float* acc_s = q_s + rep * d;          // rep * d
  float* k_s = acc_s + rep * d;          // bs * dk
  float* v_s = k_s + bs * dk;            // bs * d
  float* p_s = v_s + bs * d;             // rep * bs, scores then probabilities
  float* m_s = p_s + rep * bs;           // rep running max
  float* l_s = m_s + rep;                // rep running sum
  float* a_s = l_s + rep;                // rep rescale factor of this page

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const TQ* qb = q + ((size_t)b * H + (size_t)g * rep) * d;
  for (int e = tid; e < rep * d; e += blockDim.x) {
    q_s[e] = to_f32(qb[e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < rep; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  const int ctx = ctx_len[b];
  const int n_pages = ctx > 0 ? min((ctx + bs - 1) / bs, max_blk) : 0;
  const int j1 = min((s + 1) * pps, n_pages);
  const size_t tok_stride = (size_t)KV * d;
  const size_t page_stride = (size_t)bs * tok_stride;
  for (int j = s * pps; j < j1; ++j) {
    const int blk = table[(size_t)b * max_blk + j];
    if (blk < 0) continue;               // the same for every thread
    const int n_tok = min(bs, ctx - j * bs);
    const TKV* kp = k_pool + (size_t)blk * page_stride + (size_t)g * d;
    const TKV* vp = v_pool + (size_t)blk * page_stride + (size_t)g * d;
    __syncthreads();                     // previous page fully consumed
    for (int e = tid; e < n_tok * d; e += blockDim.x) {
      const int t = e / d;
      const int dd = e - t * d;
      k_s[t * dk + dd] = to_f32(kp[(size_t)t * tok_stride + dd]);
      v_s[t * d + dd] = to_f32(vp[(size_t)t * tok_stride + dd]);
    }
    __syncthreads();

    // scores of every (head, token) pair
    for (int e = tid; e < rep * bs; e += blockDim.x) {
      const int r = e / bs;
      const int t = e - r * bs;
      float dot = kNeg;
      if (t < n_tok) {
        const float* qr = q_s + r * d;
        const float* kr = k_s + t * dk;
        dot = 0.f;
        for (int dd = 0; dd < d; ++dd) dot += qr[dd] * kr[dd];
      }
      p_s[e] = dot;
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int r = warp; r < rep; r += nwarps) {
      float* pr = p_s + r * bs;
      float mx = kNeg;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, kMaxClamp);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(pr[t] - m_safe);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(fmaxf(m_prev, kMaxClamp) - m_safe);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < rep * d; e += blockDim.x) {
      const int r = e / d;
      const int dd = e - r * d;
      const float* pr = p_s + r * bs;
      float a = acc_s[e] * a_s[r];
      for (int t = 0; t < n_tok; ++t) a += pr[t] * v_s[t * d + dd];
      acc_s[e] = a;
    }
  }
  __syncthreads();

  const size_t base = (((size_t)b * KV + g) * n_split + s) * rep;
  for (int e = tid; e < rep * d; e += blockDim.x) part_acc[base * d + e] = acc_s[e];
  for (int r = tid; r < rep; r += blockDim.x) {
    part_ml[(base + r) * 2] = m_s[r];
    part_ml[(base + r) * 2 + 1] = l_s[r];
  }
}

// Merge the splits of one (row, kv head): the online-softmax rescale, once
// more across splits.  A split with no live page carries (-1e30, 0, 0).
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    TQ* __restrict__ out, int H, int KV, int d, int n_split) {
  const int rep = H / KV;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const size_t base = ((size_t)b * KV + g) * n_split;
  for (int e = threadIdx.x; e < rep * d; e += blockDim.x) {
    const int r = e / d;
    float m = kNeg;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_ml[((base + s) * rep + r) * 2]);
    const float m_safe = fmaxf(m, kMaxClamp);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t i = (base + s) * rep + r;
      const float w = expf(fmaxf(part_ml[i * 2], kMaxClamp) - m_safe);
      l += w * part_ml[i * 2 + 1];
      a += w * part_acc[i * d + (e - r * d)];
    }
    store(out + ((size_t)b * H + (size_t)g * rep) * d + e, a / fmaxf(l, kDenomFloor));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* ctx_len, void* out,
                   float* part_ml, float* part_acc, int B, int H, int KV, int d,
                   int bs, int max_blk, int pps, int n_split, float scale,
                   cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = sizeof(float) *
      (2 * (size_t)rep * d + (size_t)bs * (d + 1) + (size_t)bs * d + (size_t)rep * bs + 3 * (size_t)rep);
  auto split = paged_split_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(B, KV, n_split), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(ctx_len), part_ml, part_acc, H, KV, d, bs,
      max_blk, pps, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<TQ><<<dim3(B, KV), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<TQ*>(out), H, KV, d, n_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// part_ml / part_acc: f32 scratch of B * KV * n_split * rep * 2 and
// * d floats.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* ctx_len, void* out, void* part_ml, void* part_acc, int B, int H,
    int KV, int d, int bs, int max_blk, int pps, int n_split, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  if (H % KV != 0 || pps < 1 || n_split * pps < max_blk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
#define REPRO_PAGED(TQ, TKV) \
  launch<TQ, TKV>(q, k_pool, v_pool, table, ctx_len, out, ml, acc, B, H, KV, d, bs, max_blk, pps, n_split, scale, s)
  cudaError_t err;
  if (q_dtype == kF32 && kv_dtype == kF32) err = REPRO_PAGED(float, float);
  else if (q_dtype == kF32 && kv_dtype == kBF16) err = REPRO_PAGED(float, __nv_bfloat16);
  else if (q_dtype == kBF16 && kv_dtype == kF32) err = REPRO_PAGED(__nv_bfloat16, float);
  else if (q_dtype == kBF16 && kv_dtype == kBF16) err = REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
  else err = cudaErrorInvalidValue;
#undef REPRO_PAGED
  return (int)err;
}
