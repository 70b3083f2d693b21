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
// lengths, q_offsets: (B,) int32. A row of length 0, and a token that sees
// no key, writes exact zeros. float32 or bfloat16 storage, float32
// arithmetic and softmax, 1 <= Dh <= 256.
//
// Replaces the TPU kernel src/repro/kernels/verify.py::paged_verify_attention,
// which ran a (B, Hkv, pages) grid with scalar-prefetched tables, lengths and
// offsets, carried the online-softmax state of all Sq*G query rows across
// the sequential page axis in VMEM, skipped pages at or past the row's
// frontier with pl.when, and padded Dh to 128 lanes and page slots to 8.
// Here the page table is split across blocks and merged by a second kernel,
// each block stops at its rows' frontier min(lengths[b], q_offsets[b] +
// Sq) and masks each query row at its own position, and page_size and Dh
// are run-time values (templates for Dh <= 64, 128, 256); nothing is
// padded.
//
// Bound on the H100: bytes. A row reads its frontier's K and V values once
// per KV head and does 2 * Sq * G multiply-adds per value read (80 for
// Gemma-2B with spec_k = 4), under the float32 ridge of ~20 per byte. At
// the engine's shape (B 8, Sq 5, one KV head, Dh 256, 13 pages of 16) that
// is 2.4 MB, 0.7 us; what a call costs is latency: two launches and one
// page a block.
//
// Design (csrc/paged_split.cuh, shared with the decode kernel): a block owns
// 32 (token, head) rows of one (row, KV head), the Sq tokens and G heads
// packed together (40 rows at the engine's shape: two row blocks), and one
// run of whole pages planned on the host (kernels/paged_attn.py::
// plan_page_splits: one page a block at the engine's shape, 208 blocks);
// lanes run along the head dims with Q and O in registers, K/V rows are
// gathered through the table by cp.async, and paged_verify_merge_kernel
// combines the splits in a fixed order. Shared memory is 70 KB a block at
// Dh 256 whatever Sq * G is. At Sq = 1 and q_offsets = lengths - 1 this
// kernel and csrc/paged_attn.cu give the same bits.
#include "paged_split.cuh"

namespace {

template <typename T, int kDim>
__global__ void __launch_bounds__(paged::kThreads, 2)
paged_verify_kernel(const paged::Args<T> a) {
  paged::split_body<T, kDim>(a);
}

template <typename T>
__global__ void __launch_bounds__(paged::kMergeThreads)
paged_verify_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                          size_t total_rows, int d, int n_splits) {
  merge_splits<T>(part, out, total_rows, d, n_splits,
                  static_cast<size_t>(blockIdx.x) * paged::kMergeThreads +
                      threadIdx.x);
}

template <typename T, int kDim>
int launch(const paged::Args<T>& a, int n_splits, cudaStream_t stream) {
  static size_t configured = 0;  // one per kernel instantiation
  return paged::launch_split_merge<T, kDim>(
      paged_verify_kernel<T, kDim>, paged_verify_merge_kernel<T>, configured,
      a, n_splits, stream);
}

template <typename T>
int launch_dim(const paged::Args<T>& a, int n_splits, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, n_splits, stream);
  if (a.d <= 128) return launch<T, 128>(a, n_splits, stream);
  return launch<T, 256>(a, n_splits, stream);
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* lengths,
                 const void* q_offsets, void* out, void* scratch, int batch,
                 int sq, int hkv, int groups, int dh, int page_size,
                 int pages_per_row, int n_splits, int pages_per_split,
                 float scale, cudaStream_t stream) {
  const paged::Args<T> a{
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offsets),
      static_cast<T*>(out), static_cast<float*>(scratch), batch, sq,
      hkv * groups, hkv, dh, page_size, pages_per_row, pages_per_split, 1,
      scale};
  return launch_dim<T>(a, n_splits, stream);
}

}  // namespace

// The page table [0, pages_per_row) is cut into n_splits runs of
// pages_per_split pages; with n_splits > 1, scratch holds n_splits * B * Sq
// * H * (Dh + 2) floats (the partial outputs, then the (m, l) pairs).
extern "C" int paged_verify_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, const void* q_offsets,
                                   void* out, void* scratch, int batch, int sq,
                                   int hkv, int groups, int dh, int page_size,
                                   int pages_per_row, int n_splits,
                                   int pages_per_split, float scale, int dtype,
                                   void* stream) {
  if (q_offsets == nullptr ||
      paged::bad_args(batch, sq, hkv, groups, dh, page_size, pages_per_row,
                      n_splits, pages_per_split, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_typed<float>(q, k_pool, v_pool, tables, lengths, q_offsets,
                               out, scratch, batch, sq, hkv, groups, dh,
                               page_size, pages_per_row, n_splits,
                               pages_per_split, scale, st);
  if (dtype == kDtypeBF16)
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths,
                                       q_offsets, out, scratch, batch, sq, hkv,
                                       groups, dh, page_size, pages_per_row,
                                       n_splits, pages_per_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
