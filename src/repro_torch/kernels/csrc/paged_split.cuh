// The split kernel body and launcher shared by the two paged attention
// kernels: csrc/paged_attn.cu (decode, one query token a row) and
// csrc/verify.cu (Sq draft tokens a row with a per-row causal frontier).
// Decode is verify at Sq = 1 with the frontier at lengths[b] - 1, so both
// run this one body and give the same bits there.
//
// Design (after csrc/flash_attn.cu's split kernel). A block owns up to 32
// (token, head) rows of one (batch row, KV head): the G query heads of the
// KV head, and the Sq tokens, are packed into the rows (row f = i * G + g),
// so each staged K/V row feeds every query row that reads it. The grid's
// second axis splits the page table [0, P) into runs of whole pages, planned
// on the host from the sizes alone (kernels/paged_attn.py::plan_page_splits)
// so that the card gets at least one block per SM where the work allows.
// Each block reads its row's length and offset from device memory, clips
// its pages to the last position its rows see, min(len, off + last token +
// 1), and walks that range in tiles of 32 positions: each position's K and
// V rows are gathered through the page table into shared memory by 16-byte
// cp.async (bf16 widened through registers), V(t) landing while S(t) is
// computed and K(t+1) while O(t) is. 4 warps own 8 rows each; lanes run
// along the head dims with Q and the O accumulator in registers, S is summed
// across the lanes by a reduce-scatter per 4 positions (groups of 4
// positions past the tile's end are skipped), and each query row is masked
// at its own position. A block writes its unnormalised float32 partial (m,
// l, o) to scratch, or with one split the normalised output; a split that
// sees no key writes m = -1e30, l = 0, o = 0, so a row of length 0 ends as
// exact zeros. The merge kernel (merge_splits in common.cuh) combines the
// splits in a fixed order. No atomics: the same inputs give the same bits.
//
// Registers per thread (ptxas, sm_90a, -O3, CUDA 12.8): the split kernels
// 231 at Dh 256 (229 bf16), 155 at 128 and 64 (152 and 149 bf16), no
// spills (launch bounds of 128 threads, 2 blocks per SM); the merge kernels
// 32. Shared memory: 70 KB a block at Dh 256, whatever Sq * G is.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // (token, head) rows per block
constexpr int kKeys = 32;                     // positions per staged tile
constexpr int kMaxDim = 256;
constexpr int kMergeThreads = 128;  // one (row, 4 head dims) each

// One launch's operands. q: (B, Sq, H, Dh); pools: (NP + 1, page_size, Hkv,
// Dh); tables: (B, P); lengths, q_offsets: (B,) int32, q_offsets nullptr
// for decode (the frontier is lengths - 1); out: like q; part: the split
// partials, n_splits * B * Sq * H * (Dh + 2) floats (unused with one split).
template <typename T>
struct Args {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* tables;
  const int* lengths;
  const int* q_offsets;
  T* out;
  float* part;
  int batch, sq, heads, hkv, d, page_size, pages_per_row, pages_per_split,
      row_tiles;
  float scale;
};

template <typename T, int kDim>
__device__ __forceinline__ void split_body(const Args<T>& a) {
  constexpr int kStride = kDim + 4;       // padded shared row
  constexpr int kChunks = kDim / 4;       // 16-byte head-dim chunks
  constexpr int NQ = (kChunks + 31) / 32; // chunks per lane: c = lane + 32 i
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // (kKeys, kStride)
  float* v_s = k_s + kKeys * kStride;   // (kKeys, kStride)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* p_s = v_s + kKeys * kStride + warp * kKeys * kRowsPerWarp;  // (kKeys, 8)

  const int d = a.d, sq = a.sq, heads = a.heads, ps = a.page_size;
  const int groups = heads / a.hkv;
  const int rt = blockIdx.x % a.row_tiles, bh = blockIdx.x / a.row_tiles;
  const int bi = bh / a.hkv, kh = bh % a.hkv;
  const int nrows = sq * groups;
  const int r0 = rt * kRows;
  const int rows_here = min(kRows, nrows - r0);
  const int len = a.lengths[bi];
  const int qoff = a.q_offsets != nullptr ? a.q_offsets[bi] : len - 1;

  // This block's positions: its split's pages, clipped to the row's length
  // and to the last position its rows see.
  const int page0 = blockIdx.y * a.pages_per_split;
  const int lo = page0 * ps;
  int hi = min(page0 + a.pages_per_split, a.pages_per_row) * ps;
  hi = min(hi, min(len, qoff + (r0 + rows_here - 1) / groups + 1));
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  // The warp's rows are wr0 + rr, rr = 0..7; a lane covers head-dim chunks
  // lane + 32 i of all 8 in O (and in Q, held in registers), and row
  // sr = lane / 4, positions 4 g + lane % 4 (g = 0..7) of S.
  const int wr0 = r0 + warp * kRowsPerWarp;
  auto out_row = [&](int r) {  // (b, token, head) of block-relative row r
    return (static_cast<size_t>(bi) * sq + r / groups) * heads + kh * groups + r % groups;
  };
  const int sr = lane >> 2;
  const bool s_live = wr0 + sr < nrows;
  const int s_qpos = qoff + (s_live ? (wr0 + sr) / groups : 0);

  const bool vec_q = d % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(a.q) & (4 * sizeof(T) - 1)) == 0;
  float4 qr[kRowsPerWarp][NQ];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const bool live = wr0 + rr < nrows;
    const T* src = a.q + (live ? out_row(wr0 + rr) : 0) * d;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c = lane + 32 * i;
      qr[rr][i] = live && c < kChunks && 4 * c < d
                      ? load4<T>(src + 4 * c, d - 4 * c, vec_q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float m_i = kNegInf, l_i = 0.f;  // row sr's, the same in its 4 lanes
  float o[kRowsPerWarp][NQ][4];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[rr][i][c] = 0.f;

  const bool vec = d % (16 / static_cast<int>(sizeof(T))) == 0 &&
                   aligned16(a.k_pool) && aligned16(a.v_pool);
  const int* table = a.tables + static_cast<size_t>(bi) * a.pages_per_row;
  auto stage_kv = [&](float* dst, const T* pool, int k0) {
    stage_rows<kWarps, T>(dst, kStride, min(kKeys, hi - k0), d, vec, [&](int j) {
      const int pos = k0 + j;
      const int page = table[pos / ps];
      return pool + ((static_cast<size_t>(page) * ps + pos % ps) * a.hkv + kh) * d;
    });
  };

  if (n_tiles > 0) {
    if (d < kDim) {  // head dims past d: zero in k_s, which S reads
      const int pad = kDim - d;
      for (int e = tid; e < kKeys * pad; e += kThreads)
        k_s[(e / pad) * kStride + d + e % pad] = 0.f;
    }
    stage_kv(k_s, a.k_pool, lo);
    cp_async_commit();
    stage_kv(v_s, a.v_pool, lo);
    cp_async_commit();
    cp_async_wait<1>();  // K(0); V(0) may still be in flight
    __syncthreads();

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = lo + t * kKeys;
      const int nk = min(kKeys, hi - k0);

      // S = Q K^T: per 4 positions, each lane's partial dot products over
      // its chunks for 8 rows x 4 positions, reduce-scattered across the
      // warp. A group wholly past nk (a 16-slot page fills half a tile) is
      // skipped: nk is the same in the whole block.
      float s[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        s[g] = 0.f;
        if (4 * g >= nk) continue;
        float x[32];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 kv[NQ];
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const int c = lane + 32 * i;
            kv[i] = c < kChunks ? *reinterpret_cast<const float4*>(
                                      k_s + (4 * g + kk) * kStride + 4 * c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < NQ; ++i) acc = dot4(qr[rr][i], kv[i], acc);
            x[rr * 4 + kk] = acc;
          }
        }
        s[g] = reduce_scatter32(x, lane);
      }

      // Online softmax on registers; the 4 lanes of row sr hold its
      // positions. hi <= len, so a row sees a position below the tile's end
      // exactly when it is at or before the row's own.
      float mx = kNegInf;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int kj = 4 * g + (lane & 3);
        const bool vis = s_live && kj < nk && k0 + kj <= s_qpos;
        s[g] = vis ? s[g] * a.scale : kNegInf;
        mx = fmaxf(mx, s[g]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        s[g] = s[g] == kNegInf ? 0.f : expf(s[g] - m_new);
        sum += s[g];
        p_s[(4 * g + (lane & 3)) * kRowsPerWarp + sr] = s[g];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * alpha + sum;
      m_i = m_new;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float al = __shfl_sync(0xffffffffu, alpha, 4 * rr);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[rr][i][c] *= al;
      }

      cp_async_wait<0>();
      __syncthreads();  // V(t) and P visible; every warp is done with K(t)
      if (t + 1 < n_tiles) {
        stage_kv(k_s, a.k_pool, k0 + kKeys);
        cp_async_commit();
      }

      // O += P V: P of the warp's 8 rows by broadcast, V by this lane's chunks.
#pragma unroll 2
      for (int j = 0; j < nk; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + j * kRowsPerWarp);
        const float4 pb = *reinterpret_cast<const float4*>(p_s + j * kRowsPerWarp + 4);
        const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int c = lane + 32 * i;
          if (c >= kChunks) continue;
          const float4 vv = *reinterpret_cast<const float4*>(v_s + j * kStride + 4 * c);
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            o[rr][i][0] = fmaf(p[rr], vv.x, o[rr][i][0]);
            o[rr][i][1] = fmaf(p[rr], vv.y, o[rr][i][1]);
            o[rr][i][2] = fmaf(p[rr], vv.z, o[rr][i][2]);
            o[rr][i][3] = fmaf(p[rr], vv.w, o[rr][i][3]);
          }
        }
      }
      if (t + 1 < n_tiles) {
        cp_async_wait<0>();
        __syncthreads();  // K(t+1) visible; every warp is done with V(t), P
        stage_kv(v_s, a.v_pool, k0 + kKeys);
        cp_async_commit();
      }
    }
  }

  // One split: the normalised output. Several: this split's partial.
  const size_t total_rows = static_cast<size_t>(a.batch) * sq * heads;
  const bool final_out = gridDim.y == 1;
  const bool vo = d % 4 == 0 && (reinterpret_cast<unsigned long long>(a.out) &
                                 (4 * sizeof(T) - 1)) == 0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const float l_r = __shfl_sync(0xffffffffu, l_i, 4 * rr);
    if (wr0 + rr >= nrows) continue;
    const size_t orow = out_row(wr0 + rr);
    const size_t prow = static_cast<size_t>(blockIdx.y) * total_rows + orow;
    const float den = fmaxf(l_r, 1e-30f);  // l == 0: no visible key, o == 0
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c0 = 4 * (lane + 32 * i);
      if (c0 >= d || c0 >= kDim) continue;
      if (final_out) {
        const float x[4] = {o[rr][i][0] / den, o[rr][i][1] / den,
                            o[rr][i][2] / den, o[rr][i][3] / den};
        store4<T>(a.out + orow * d + c0, x, d - c0, vo);
      } else {
        const float x[4] = {o[rr][i][0], o[rr][i][1], o[rr][i][2], o[rr][i][3]};
        store4<float>(a.part + prow * d + c0, x, d - c0, d % 4 == 0);
      }
    }
  }
  if (!final_out && s_live && (lane & 3) == 0) {
    float* ml = a.part + static_cast<size_t>(gridDim.y) * total_rows * d +
                2 * (static_cast<size_t>(blockIdx.y) * total_rows + out_row(wr0 + sr));
    ml[0] = m_i;
    ml[1] = l_i;
  }
}

// Launch one source's split kernel over the plan's grid (row tiles x batch
// x KV heads, n_splits), then its merge kernel when there is more than one
// split. ``configured`` is the caller's record of the split kernel's shared
// memory ceiling (see allow_smem).
template <typename T, int kDim, typename Split, typename Merge>
int launch_split_merge(Split split, Merge merge, size_t& configured,
                       Args<T> a, int n_splits, cudaStream_t stream) {
  constexpr int kStride = kDim + 4;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(kKeys) * kStride + kWarps * kKeys * kRowsPerWarp);
  const long long nrows = static_cast<long long>(a.sq) * (a.heads / a.hkv);
  const long long row_tiles = (nrows + kRows - 1) / kRows;
  const long long blocks = row_tiles * a.batch * a.hkv;
  const long long total_rows = static_cast<long long>(a.batch) * a.sq * a.heads;
  const long long merge_blocks =
      (total_rows * ((a.d + 3) / 4) + kMergeThreads - 1) / kMergeThreads;
  if (nrows > 0x7fffffff || blocks > 0x7fffffff || merge_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(split, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.row_tiles = static_cast<int>(row_tiles);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_splits));
  split<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  merge<<<static_cast<unsigned>(merge_blocks), kMergeThreads, 0, stream>>>(
      a.part, a.out, static_cast<size_t>(total_rows), a.d, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// True for what the kernels do not take: Dh past kMaxDim, a plan that does
// not cover [0, P) with n_splits runs of pages_per_split pages, a position
// past an int, or several splits without scratch.
inline bool bad_args(int batch, int sq, int hkv, int groups, int dh,
                     int page_size, int pages_per_row, int n_splits,
                     int pages_per_split, const void* scratch) {
  return batch < 0 || sq < 1 || hkv < 1 || groups < 1 || dh < 1 ||
         dh > kMaxDim || page_size < 1 || pages_per_row < 0 || n_splits < 1 ||
         n_splits > 65535 || pages_per_split < 1 ||
         static_cast<long long>(n_splits) * pages_per_split < pages_per_row ||
         static_cast<long long>(n_splits) * pages_per_split * page_size >
             0x7fffffffLL ||
         (n_splits > 1 && scratch == nullptr);
}

}  // namespace paged
