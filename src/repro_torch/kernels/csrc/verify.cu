// Speculative verify: Sq query tokens per row against a paged KV pool, with
// a per-row causal frontier.
//
//     o[b, i] = softmax(q[b, i] . K[pages(b)]^T / sqrt(Dh)) . V[pages(b)]
//
// q: (B, Sq, H, Dh) with H = Hkv * G (query head h*G+g reads KV head h);
// token i of row b sits at absolute position q_offsets[b] + i and sees the
// KV positions <= q_offsets[b] + i and < lengths[b]. k_pool/v_pool:
// (NP + 1, page_size, Hkv, Dh); tables: (B, P) int32, entry j naming the
// page that holds the row's positions [j*page_size, (j+1)*page_size);
// lengths, q_offsets: (B,) int32. A row of length 0 writes exact zeros.
// float32 or bfloat16 storage, float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/verify.py::paged_verify_attention,
// which ran a (B, Hkv, pages) grid with scalar-prefetched tables, lengths and
// offsets, carried the online-softmax state of all Sq*G query rows across
// the sequential page axis in VMEM, skipped pages at or past the row's
// frontier with pl.when, and padded Dh to 128 lanes and page slots to 8.
// Here one block walks its row's pages in a loop, stops at the frontier
// min(lengths[b], q_offsets[b] + Sq), and masks each query row at its own
// position itself; page_size and Dh are run-time values, nothing is padded.
//
// Bound on the H100: bytes. A row reads its frontier's K and V values once
// per KV head and does 2 * Sq * G multiply-adds per value read (80 for
// Gemma-2B with spec_k = 4), under the float32 ridge of ~20 per byte.
// Design: grid (B, Hkv), 256 threads, as csrc/paged_attn.cu, generalised
// from G query rows to Sq * G: the block stages one page of K and V for its
// KV head in shared memory and every query row of every draft token reads it
// there, so each K/V byte leaves device memory once per row. Scores are one
// warp per (query row, slot) dot product, the online-softmax update one warp
// per query row over that row's visible slots, and the (Sq*G, Dh) float32
// accumulator stays in shared memory (40 KB at Gemma-2B's shape, ~115 KB in
// all, so the launcher raises the block's dynamic limit once). The page loop
// is paged_attn.cu's, step for step: at Sq = 1 with q_offsets = lengths - 1
// every query row sees exactly the slots decode sees, and the two kernels
// give the same bits. With B * Hkv blocks the card is far from full at
// decode batch sizes; splitting the page walk across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ q_offsets, T* __restrict__ out,
                    int sq, int hkv, int groups, int dh, int page_size,
                    int pages_per_row, float scale) {
  extern __shared__ float smem[];
  const int G = groups;
  const int R = sq * G;                  // query rows: flat row f = i*G + g
  float* q_s = smem;                     // (R, dh)
  float* acc_s = q_s + R * dh;           // (R, dh)
  float* k_s = acc_s + R * dh;           // (page_size, dh)
  float* v_s = k_s + page_size * dh;     // (page_size, dh)
  float* p_s = v_s + page_size * dh;     // (R, page_size)
  float* m_s = p_s + R * page_size;      // (R,)
  float* l_s = m_s + R;                  // (R,)
  float* alpha_s = l_s + R;              // (R,)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int heads = hkv * G;
  const int len = lengths[b];
  const int off = q_offsets[b];

  for (int e = tid; e < R * dh; e += kThreads) {
    const int f = e / dh, d = e % dh;
    const size_t src =
        ((static_cast<size_t>(b) * sq + f / G) * heads + h * G + f % G) * dh + d;
    q_s[e] = to_f32(q[src]);
    acc_s[e] = 0.f;
  }
  for (int f = tid; f < R; f += kThreads) {
    m_s[f] = kNegInf;
    l_s[f] = 0.f;
  }
  __syncthreads();

  // No query token of the row sees a position at or past the frontier.
  const int frontier = max(min(len, off + sq), 0);
  const int npages = min((frontier + page_size - 1) / page_size, pages_per_row);
  for (int j = 0; j < npages; ++j) {
    const int page = tables[static_cast<size_t>(b) * pages_per_row + j];
    const int base = j * page_size;
    const int nvalid = min(page_size, frontier - base);
    for (int e = tid; e < nvalid * dh; e += kThreads) {
      const int slot = e / dh, d = e % dh;
      const size_t off_kv =
          ((static_cast<size_t>(page) * page_size + slot) * hkv + h) * dh + d;
      k_s[e] = to_f32(k_pool[off_kv]);
      v_s[e] = to_f32(v_pool[off_kv]);
    }
    __syncthreads();

    for (int pair = warp; pair < R * nvalid; pair += nwarps) {
      const int f = pair / nvalid, slot = pair % nvalid;
      float dot = 0.f;
      for (int d = lane; d < dh; d += 32) dot += q_s[f * dh + d] * k_s[slot * dh + d];
      dot = warp_sum(dot);
      if (lane == 0) p_s[f * page_size + slot] = dot * scale;
    }
    __syncthreads();

    // Query row f (token f / G) sees this page's slots below
    // min(len, off + f / G + 1); a row that sees none keeps its state.
    for (int f = warp; f < R; f += nwarps) {
      const int nf = min(nvalid, min(len, off + f / G + 1) - base);
      float* pf = p_s + f * page_size;
      float mx = kNegInf;
      for (int s = lane; s < nf; s += 32) mx = fmaxf(mx, pf[s]);
      mx = warp_max(mx);
      const float m_old = m_s[f];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < nf; s += 32) {
        const float p = expf(pf[s] - m_new);
        pf[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);  // also orders every lane's read of m_s[f]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[f] = alpha;
        l_s[f] = l_s[f] * alpha + sum;
        m_s[f] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < R * dh; e += kThreads) {
      const int f = e / dh, d = e % dh;
      const int nf = min(nvalid, min(len, off + f / G + 1) - base);
      const float* pf = p_s + f * page_size;
      float acc = acc_s[e] * alpha_s[f];
      for (int s = 0; s < nf; ++s) acc += pf[s] * v_s[s * dh + d];
      acc_s[e] = acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * dh; e += kThreads) {
    const int f = e / dh, d = e % dh;
    const size_t dst =
        ((static_cast<size_t>(b) * sq + f / G) * heads + h * G + f % G) * dh + d;
    const float o = len > 0 ? acc_s[e] / fmaxf(l_s[f], 1e-30f) : 0.f;
    out[dst] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, const void* q_offsets,
           void* out, int batch, int sq, int hkv, int groups, int dh,
           int page_size, int pages_per_row, float scale, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(sq) * groups;
  const size_t smem = sizeof(float) *
      (2 * rows * dh + 2 * static_cast<size_t>(page_size) * dh +
       rows * page_size + 3 * rows);
  static size_t configured = 0;  // one per kernel and type
  cudaError_t err = allow_smem(paged_verify_kernel<T>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, hkv);
  paged_verify_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offsets),
      static_cast<T*>(out), sq, hkv, groups, dh, page_size, pages_per_row,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_verify_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, const void* q_offsets,
                                   void* out, int batch, int sq, int hkv,
                                   int groups, int dh, int page_size,
                                   int pages_per_row, float scale, int dtype,
                                   void* stream) {
  if (batch < 0 || sq < 1 || hkv < 1 || groups < 1 || dh < 1 ||
      page_size < 1 || pages_per_row < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch<float>(q, k_pool, v_pool, tables, lengths, q_offsets, out,
                         batch, sq, hkv, groups, dh, page_size, pages_per_row,
                         scale, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, q_offsets,
                                 out, batch, sq, hkv, groups, dh, page_size,
                                 pages_per_row, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
