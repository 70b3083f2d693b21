// Paged-attention decode: one query token per row against a paged KV pool.
//
//     o[b] = softmax(q[b] . K[pages(b)]^T / sqrt(Dh)) . V[pages(b)]
//
// q: (B, H, Dh) with H = Hkv * G (query head h*G+g reads KV head h);
// k_pool/v_pool: (NP + 1, page_size, Hkv, Dh); tables: (B, P) int32, entry j
// naming the page that holds the row's positions [j*page_size,
// (j+1)*page_size); lengths: (B,) int32. Positions >= lengths[b] are
// masked; a row of length 0 writes exact zeros. float32 or bfloat16
// storage, float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attention,
// which walked pages as a sequential grid axis with scalar-prefetched
// tables, skipped pages past the length with pl.when, and padded Dh to 128
// lanes and page slots to 8 sublanes. Here a block walks its own pages in a
// loop, stops at the last page below lengths[b], masks the partial last
// page itself, and takes page_size and Dh at run time; no padding.
//
// Bound on the H100: bytes. Each row must read lengths[b] * Hkv * Dh K and V
// values and does 2 * G multiply-adds per value read (G = 8 for Gemma-2B),
// well under the float32 ridge. Design: grid (B, Hkv), 256 threads. The
// block stages one page of K and V for its KV head in shared memory and all
// G query heads read it from there, so every K/V byte leaves device memory
// once per row, not G times. Scores are one warp per (head, slot) dot
// product; the online-softmax update is one warp per head; the accumulator
// (G, Dh) stays in shared memory. With B * Hkv blocks the card is far from
// full at decode batch sizes; splitting the page walk across blocks is
// later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  int hkv, int groups, int dh, int page_size,
                  int pages_per_row, float scale) {
  extern __shared__ float smem[];
  const int G = groups;
  float* q_s = smem;                     // (G, dh)
  float* acc_s = q_s + G * dh;           // (G, dh)
  float* k_s = acc_s + G * dh;           // (page_size, dh)
  float* v_s = k_s + page_size * dh;     // (page_size, dh)
  float* p_s = v_s + page_size * dh;     // (G, page_size)
  float* m_s = p_s + G * page_size;      // (G,)
  float* l_s = m_s + G;                  // (G,)
  float* alpha_s = l_s + G;              // (G,)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int heads = hkv * G;
  const size_t q_base = (static_cast<size_t>(b) * heads + h * G) * dh;
  const int len = lengths[b];

  for (int e = tid; e < G * dh; e += kThreads) {
    q_s[e] = to_f32(q[q_base + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int npages = min((len + page_size - 1) / page_size, pages_per_row);
  for (int j = 0; j < npages; ++j) {
    const int page = tables[static_cast<size_t>(b) * pages_per_row + j];
    const int nvalid = min(page_size, len - j * page_size);
    for (int e = tid; e < nvalid * dh; e += kThreads) {
      const int slot = e / dh, d = e % dh;
      const size_t off =
          ((static_cast<size_t>(page) * page_size + slot) * hkv + h) * dh + d;
      k_s[e] = to_f32(k_pool[off]);
      v_s[e] = to_f32(v_pool[off]);
    }
    __syncthreads();

    for (int pair = warp; pair < G * nvalid; pair += nwarps) {
      const int g = pair / nvalid, slot = pair % nvalid;
      float dot = 0.f;
      for (int d = lane; d < dh; d += 32) dot += q_s[g * dh + d] * k_s[slot * dh + d];
      dot = warp_sum(dot);
      if (lane == 0) p_s[g * page_size + slot] = dot * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float* pg = p_s + g * page_size;
      float mx = kNegInf;
      for (int s = lane; s < nvalid; s += 32) mx = fmaxf(mx, pg[s]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < nvalid; s += 32) {
        const float p = expf(pg[s] - m_new);
        pg[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);  // also orders every lane's read of m_s[g]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * dh; e += kThreads) {
      const int g = e / dh, d = e % dh;
      const float* pg = p_s + g * page_size;
      float acc = acc_s[e] * alpha_s[g];
      for (int s = 0; s < nvalid; ++s) acc += pg[s] * v_s[s * dh + d];
      acc_s[e] = acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * dh; e += kThreads) {
    const float o = len > 0 ? acc_s[e] / fmaxf(l_s[e / dh], 1e-30f) : 0.f;
    out[q_base + e] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int batch,
           int hkv, int groups, int dh, int page_size, int pages_per_row,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(groups) * dh + 2 * static_cast<size_t>(page_size) * dh +
       static_cast<size_t>(groups) * page_size + 3 * static_cast<size_t>(groups));
  static size_t configured = 0;  // one per kernel and type
  cudaError_t err = allow_smem(paged_attn_kernel<T>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, hkv);
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), hkv, groups, dh,
      page_size, pages_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attn_launch(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, void* out, int batch,
                                 int hkv, int groups, int dh, int page_size,
                                 int pages_per_row, float scale, int dtype,
                                 void* stream) {
  if (batch < 0 || hkv < 1 || groups < 1 || dh < 1 || page_size < 1 ||
      pages_per_row < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, batch, hkv,
                         groups, dh, page_size, pages_per_row, scale, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, batch,
                                 hkv, groups, dh, page_size, pages_per_row,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
