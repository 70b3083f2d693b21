// Paged-attention decode: one query token per row against a paged KV pool.
//
//     o[b] = softmax(q[b] . K[pages(b)]^T / sqrt(Dh)) . V[pages(b)]
//
// q: (B, H, Dh) with H = Hkv * G (query head h*G+g reads KV head h);
// k_pool/v_pool: (NP + 1, page_size, Hkv, Dh); tables: (B, P) int32, entry j
// naming the page that holds the row's positions [j*page_size,
// (j+1)*page_size); lengths: (B,) int32. Positions >= lengths[b] are
// masked; a row of length 0 writes exact zeros. float32 or bfloat16
// storage, float32 arithmetic and softmax, 1 <= Dh <= 256.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attention,
// which walked pages as a sequential grid axis with scalar-prefetched
// tables, skipped pages past the length with pl.when, and padded Dh to 128
// lanes and page slots to 8 sublanes. Here the page table is split across
// blocks and merged by a second kernel, each block masks its own ragged
// edge, and page_size and Dh are run-time values (templates for Dh <= 64,
// 128, 256); nothing is padded.
//
// Bound on the H100: bytes. Each row must read lengths[b] * Hkv * Dh K and V
// values and does 2 * G multiply-adds per value read (G = 8 for Gemma-2B),
// well under the float32 ridge. At Gemma-2B's decode shape (B 8, one KV
// head, Dh 256, 13 pages of 16) that is under 2 MB and 0.4 us; what a call
// costs is latency: two launches and one page a block.
//
// Design: decode is the Sq = 1 case of the paged verify kernel, with the
// frontier at lengths[b] - 1, and runs the same body (csrc/paged_split.cuh):
// the G query heads of a KV head share a block's rows, the page table is
// split into runs of whole pages over the grid's second axis by the host's
// plan (kernels/paged_attn.py::plan_page_splits: one page a block at the
// engine's shape, 104 blocks), and paged_attn_merge_kernel combines the
// splits in a fixed order. At Sq = 1 and q_offsets = lengths - 1 this kernel
// and csrc/verify.cu give the same bits.
#include "paged_split.cuh"

namespace {

template <typename T, int kDim>
__global__ void __launch_bounds__(paged::kThreads, 2)
paged_attn_kernel(const paged::Args<T> a) {
  paged::split_body<T, kDim>(a);
}

template <typename T>
__global__ void __launch_bounds__(paged::kMergeThreads)
paged_attn_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                        size_t total_rows, int d, int n_splits) {
  merge_splits<T>(part, out, total_rows, d, n_splits,
                  static_cast<size_t>(blockIdx.x) * paged::kMergeThreads +
                      threadIdx.x);
}

template <typename T, int kDim>
int launch(const paged::Args<T>& a, int n_splits, cudaStream_t stream) {
  static size_t configured = 0;  // one per kernel instantiation
  return paged::launch_split_merge<T, kDim>(
      paged_attn_kernel<T, kDim>, paged_attn_merge_kernel<T>, configured, a,
      n_splits, stream);
}

template <typename T>
int launch_dim(const paged::Args<T>& a, int n_splits, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, n_splits, stream);
  if (a.d <= 128) return launch<T, 128>(a, n_splits, stream);
  return launch<T, 256>(a, n_splits, stream);
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* lengths, void* out,
                 void* scratch, int batch, int hkv, int groups, int dh,
                 int page_size, int pages_per_row, int n_splits,
                 int pages_per_split, float scale, cudaStream_t stream) {
  const paged::Args<T> a{
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), nullptr, static_cast<T*>(out),
      static_cast<float*>(scratch), batch, 1, hkv * groups, hkv, dh,
      page_size, pages_per_row, pages_per_split, 1, scale};
  return launch_dim<T>(a, n_splits, stream);
}

}  // namespace

// The page table [0, pages_per_row) is cut into n_splits runs of
// pages_per_split pages; with n_splits > 1, scratch holds n_splits * B * H *
// (Dh + 2) floats (the partial outputs, then the (m, l) pairs).
extern "C" int paged_attn_launch(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, void* out, void* scratch,
                                 int batch, int hkv, int groups, int dh,
                                 int page_size, int pages_per_row,
                                 int n_splits, int pages_per_split,
                                 float scale, int dtype, void* stream) {
  if (paged::bad_args(batch, 1, hkv, groups, dh, page_size, pages_per_row,
                      n_splits, pages_per_split, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_typed<float>(q, k_pool, v_pool, tables, lengths, out,
                               scratch, batch, hkv, groups, dh, page_size,
                               pages_per_row, n_splits, pages_per_split, scale,
                               st);
  if (dtype == kDtypeBF16)
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                       scratch, batch, hkv, groups, dh,
                                       page_size, pages_per_row, n_splits,
                                       pages_per_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
