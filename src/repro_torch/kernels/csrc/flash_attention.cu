// Causal (optionally windowed) flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_attn_kernel`, wrapper
// `ops.attention`): FA2-style attention with an online softmax over key
// tiles, GQA (query head h reads kv head h / rep), sliding windows, and
// queries right-aligned against the keys when Skv > Sq.
//
// What bounds it on the H100: at the serving engine's prefill shapes
// (a few rows of at most 128 tokens, d = 64) memory.  q, k, v and the
// output are read or written once; the work is 4 * d flops per visible
// (query, key) pair, about 2 * S flops per byte, well under the ~295 flops
// per byte of the bf16 tensor cores at S <= 128.  The design therefore:
//   * reads the model layout (B, S, heads, d) in place through its strides
//     and masks the ragged Sq / Skv edge itself: no transpose, no padding
//     copy (the TPU wrapper transposed q, k, v and padded them to tiles);
//   * gives one thread block to each (b, h, 64-query tile); the block loads
//     each 64-key tile of its kv head once into shared memory (f32) and
//     every query row of the tile reuses it;
//   * skips whole key tiles that the causal mask or the window hides;
//   * keeps the running max, sum and accumulator of every query row in f32
//     shared memory: one warp owns a query row at a time, a lane scores two
//     keys and updates d / 32 output dims.
// It runs on the CUDA cores in f32.  Tensor-core (wgmma) tiles are the step
// that matters once prompts grow to thousands of tokens.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile (two per lane)
constexpr int kWarps = 4;
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out,                   // (B, Sq, H, d) contiguous
    int Sq, int Skv, int H, int KV, int d,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int dk = d + 1;                  // padded key rows: no bank conflicts
  float* k_s = smem;                     // kBK * dk
  float* v_s = k_s + kBK * dk;           // kBK * d
  float* q_s = v_s + kBK * d;            // kBQ * d, pre-scaled
  float* acc_s = q_s + kBQ * d;          // kBQ * d
  float* m_s = acc_s + kBQ * d;          // kBQ
  float* l_s = m_s + kBQ;                // kBQ
  float* p_s = l_s + kBQ;                // kWarps * kBK

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int q_lo = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, Sq - q_lo);
  const int off = Skv - Sq;              // absolute position of query row 0

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;

  for (int e = tid; e < kBQ * d; e += blockDim.x) {
    const int r = e / d;
    const int dd = e - r * d;
    q_s[e] = r < n_rows ? to_f32(qb[(q_lo + r) * qss + dd]) * scale : 0.f;
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < kBQ; r += blockDim.x) {
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
      k_s[t * dk + dd] = ok ? to_f32(kb[key * kss + dd]) : 0.f;
      v_s[t * d + dd] = ok ? to_f32(vb[key * vss + dd]) : 0.f;
    }
    __syncthreads();

    for (int rr = warp; rr < n_rows; rr += kWarps) {
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

  T* ob = out + (((size_t)b * Sq + q_lo) * H + h) * d;
  for (int e = tid; e < n_rows * d; e += blockDim.x) {
    const int r = e / d;
    const int dd = e - r * d;
    store(ob + (size_t)r * H * d + dd, acc_s[e] / fmaxf(l_s[r], kDenomFloor));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, int d,
                   const long long* st, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBK * (d + 1) + (size_t)kBK * d + 2 * (size_t)kBQ * d + 2 * kBQ + kWarps * kBK);
  auto kern = flash_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// strides: q (b, s, h), k (b, s, h), v (b, s, h) in elements; the last dim
// is contiguous.  Returns cudaGetLastError() after the launch (0 = launched).
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
  if (dtype == kF32)
    return (int)launch<float>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, d, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
