// Flash attention with a causal mask at a run-time absolute offset and an
// optional sliding window (chunked prefill).
//
// q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with Hkv dividing H (query head
// h reads KV head h / G, G = H / Hkv); out: (B, Sq, H, D). Query i of batch
// row b sits at absolute position q_offset[b] + i and key j at position j;
// key j is visible when j <= qpos (causal) and j > qpos - window (window).
// A query whose keys are all masked writes zeros. q_offset is either a
// (B,) int32 device array or one scalar passed by value, so a new offset
// never needs a new build. float32 or bfloat16 storage, float32 arithmetic
// and softmax, 1 <= D <= 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention,
// which ran the KV axis as a sequential grid dimension with the offset in
// scalar-prefetch memory, needed block sizes that divide Sq and Skv, took
// repeated KV heads, and was vmapped over the batch. Here the KV axis is
// split across blocks and merged by a second kernel, ragged edges are
// masked in the kernel, the shared KV head is read directly, and the batch
// is a grid dimension.
//
// Bound on the H100: operations, at 67 TFLOP/s on CUDA cores (float32, no
// TF32). One prefill chunk of Gemma-2B (64 queries x 8 heads on one KV
// head, D 256, 192 visible keys at offset 128) is 84 MFLOP, 1.3 us, and
// reads 0.2 MB of K/V; the last chunk of a 2k-token prompt (2048 keys) is
// 1.07 GFLOP, 16 us. Neither fills 132 SMs with one block per (head,
// query tile): that layout ran 32 blocks here and staged the one KV head
// 8 times. What bounds a kernel like this one on CUDA cores is shared
// memory: a warp's 16-byte shared load moves 512 bytes in 4 cycles
// whether or not its lanes share addresses, against 128 multiply-adds a
// cycle, so every float a lane loads has to feed several of them.
//
// Design. Two kernels behind one launcher:
// 1. flash_split_kernel. A block owns 32 (query, head) rows of one (batch,
//    KV head): the G query heads of a KV head are packed into the rows, so
//    each K/V tile is staged once for all G heads. The grid's second axis
//    splits the visible key range (planned on the host from the sizes alone,
//    kernels/flash_attn.py::plan_splits, for at least one block per SM);
//    each block clips its split to its rows' causal frontier and window
//    edge and walks it in tiles of 32 keys. 4 warps own 8 rows each. Lanes
//    run along the head dims: lane l holds the 16-byte chunks l + 32 i of
//    Q (read once into registers) and of the O accumulator for all 8 rows,
//    so each K or V chunk it loads from shared memory feeds 32
//    multiply-adds, 8 rows x 4. S = QK^T is summed over the lanes by a
//    reduce-scatter per 4 keys (31 shuffles for 32 (row, key) sums), after
//    which lane l holds row l / 4, keys 4 g + l % 4: the row max and sum
//    take 2 shuffles, P goes through a warp-private shared slice and comes
//    back as two broadcast loads per key. K and V have one buffer each,
//    filled by 16-byte cp.async (bf16 is widened through registers): V(t)
//    lands while S(t) is computed and K(t+1) while O(t) is, at two block
//    barriers per tile. Head dims past D are zero (templates for D <= 64,
//    128, 256). A block writes its unnormalised float32 partial (m, l, o)
//    to scratch, or with one split the final output; a split that sees none
//    of its rows' keys writes m = -1e30, l = 0, o = 0.
// 2. flash_merge_kernel: one thread per (output row, 4 head dims)
//    combines the splits in a fixed order, o = sum_s e^(m_s - M) o_s /
//    sum_s e^(m_s - M) l_s, and rounds to the storage type; a thread's
//    loads of the splits do not depend on one another.
// No atomics anywhere: the same inputs give the same bits.
//
// Registers per thread (ptxas, sm_90a, -O3, CUDA 12.8): the split kernel
// 255 in every instantiation (launch bounds of 128 threads, 2 blocks per
// SM), spilling 4 bytes for float32 D 256 and D 128, 22 (stores) and 68
// (loads) for bf16 D 256, 8 and 12 for bf16 D 128, none at D 64; the
// merge kernel 32, no spills. Shared memory: 70 KB a block at D 256.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kKeys = 32;                     // keys per staged tile
constexpr int kMaxDim = 256;
constexpr int kMergeThreads = 128;  // one (row, 4 head dims) each

template <typename T, int kDim>
__global__ void __launch_bounds__(kThreads, 2)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ q_offsets,
                   int q_offset_scalar, T* __restrict__ out,
                   float* __restrict__ part, int batch, int sq, int skv,
                   int heads, int kv_heads, int d, int causal, int window,
                   int kbeg, int kend, int split_len, int row_tiles,
                   float scale) {
  constexpr int kStride = kDim + 4;       // padded shared row
  constexpr int kChunks = kDim / 4;       // 16-byte head-dim chunks
  constexpr int NQ = (kChunks + 31) / 32; // chunks per lane: c = lane + 32 i
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // (kKeys, kStride)
  float* v_s = k_s + kKeys * kStride;   // (kKeys, kStride)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* p_s = v_s + kKeys * kStride + warp * kKeys * kRowsPerWarp;  // (kKeys, 8)

  const int groups = heads / kv_heads;
  const int rt = blockIdx.x % row_tiles, bh = blockIdx.x / row_tiles;
  const int bi = bh / kv_heads, kh = bh % kv_heads;
  const int nrows = sq * groups;
  const int r0 = rt * kRows;
  const int rows_here = min(kRows, nrows - r0);
  const int qoff = q_offsets != nullptr ? q_offsets[bi] : q_offset_scalar;

  // This block's keys: its split, clipped to what its rows can see.
  int lo = kbeg + blockIdx.y * split_len;
  int hi = min(lo + split_len, kend);
  if (causal) hi = min(hi, qoff + (r0 + rows_here - 1) / groups + 1);
  if (window > 0) lo = max(lo, qoff + r0 / groups - window + 1);
  lo = max(lo, 0);
  hi = min(hi, skv);
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  // The warp's rows are wr0 + rr, rr = 0..7; a lane covers head-dim chunks
  // lane + 32 i of all 8 in O (and in Q, held in registers), and row
  // sr = lane / 4, keys 4 g + lane % 4 (g = 0..7) of S.
  const int wr0 = r0 + warp * kRowsPerWarp;
  auto out_row = [&](int r) {  // (b, query, head) of block-relative row r
    return (static_cast<size_t>(bi) * sq + r / groups) * heads + kh * groups + r % groups;
  };
  const int sr = lane >> 2;
  const bool s_live = wr0 + sr < nrows;
  const int s_qpos = qoff + (s_live ? (wr0 + sr) / groups : 0);

  const bool vec_q = d % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(q) & (4 * sizeof(T) - 1)) == 0;
  float4 qr[kRowsPerWarp][NQ];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const bool live = wr0 + rr < nrows;
    const T* src = q + (live ? out_row(wr0 + rr) : 0) * d;
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
                   aligned16(k) && aligned16(v);
  auto stage_kv = [&](float* dst, const T* base, int k0) {
    stage_rows<kWarps, T>(dst, kStride, min(kKeys, hi - k0), d, vec, [&](int j) {
      return base + ((static_cast<size_t>(bi) * skv + k0 + j) * kv_heads + kh) * d;
    });
  };

  if (n_tiles > 0) {
    if (d < kDim) {  // head dims past d: zero in k_s, which S reads
      const int pad = kDim - d;
      for (int e = tid; e < kKeys * pad; e += kThreads)
        k_s[(e / pad) * kStride + d + e % pad] = 0.f;
    }
    stage_kv(k_s, k, lo);
    cp_async_commit();
    stage_kv(v_s, v, lo);
    cp_async_commit();
    cp_async_wait<1>();  // K(0); V(0) may still be in flight
    __syncthreads();

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = lo + t * kKeys;
      const int nk = min(kKeys, hi - k0);

      // S = Q K^T: per 4 keys, each lane's partial dot products over its
      // chunks for 8 rows x 4 keys, reduce-scattered across the warp.
      float s[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
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

      // Online softmax on registers; the 4 lanes of row sr hold its keys.
      float mx = kNegInf;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int kj = 4 * g + (lane & 3), kpos = k0 + kj;
        const bool vis = s_live && kj < nk && (!causal || kpos <= s_qpos) &&
                         (window <= 0 || kpos > s_qpos - window);
        s[g] = vis ? s[g] * scale : kNegInf;
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
        const float a = __shfl_sync(0xffffffffu, alpha, 4 * rr);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[rr][i][c] *= a;
      }

      cp_async_wait<0>();
      __syncthreads();  // V(t) and P visible; every warp is done with K(t)
      if (t + 1 < n_tiles) {
        stage_kv(k_s, k, k0 + kKeys);
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
        stage_kv(v_s, v, k0 + kKeys);
        cp_async_commit();
      }
    }
  }

  // One split: the normalised output. Several: this split's partial.
  const size_t total_rows = static_cast<size_t>(batch) * sq * heads;
  const bool final_out = gridDim.y == 1;
  const bool vo = d % 4 == 0 && (reinterpret_cast<unsigned long long>(out) &
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
        store4<T>(out + orow * d + c0, x, d - c0, vo);
      } else {
        const float x[4] = {o[rr][i][0], o[rr][i][1], o[rr][i][2], o[rr][i][3]};
        store4<float>(part + prow * d + c0, x, d - c0, d % 4 == 0);
      }
    }
  }
  if (!final_out && s_live && (lane & 3) == 0) {
    float* ml = part + static_cast<size_t>(gridDim.y) * total_rows * d +
                2 * (static_cast<size_t>(blockIdx.y) * total_rows + out_row(wr0 + sr));
    ml[0] = m_i;
    ml[1] = l_i;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                   size_t total_rows, int d, int n_splits) {
  merge_splits<T>(part, out, total_rows, d, n_splits,
                  static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x);
}

template <typename T, int kDim>
int launch(const void* q, const void* k, const void* v, const void* q_offsets,
           int q_offset_scalar, void* out, void* scratch, int batch, int sq,
           int skv, int heads, int kv_heads, int d, int causal, int window,
           int kbeg, int kend, int n_splits, int split_len, float scale,
           cudaStream_t stream) {
  constexpr int kStride = kDim + 4;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(kKeys) * kStride + kWarps * kKeys * kRowsPerWarp);
  const long long nrows = static_cast<long long>(sq) * (heads / kv_heads);
  const long long row_tiles = (nrows + kRows - 1) / kRows;
  const long long blocks = row_tiles * batch * kv_heads;
  const long long total_rows = static_cast<long long>(batch) * sq * heads;
  const long long merge_blocks =
      (total_rows * ((d + 3) / 4) + kMergeThreads - 1) / kMergeThreads;
  if (nrows > 0x7fffffff || blocks > 0x7fffffff || merge_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // one per kernel and type
  cudaError_t err = allow_smem(flash_split_kernel<T, kDim>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(scratch);
  T* o = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_splits));
  flash_split_kernel<T, kDim><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offsets),
      q_offset_scalar, o, part, batch, sq, skv, heads, kv_heads, d, causal,
      window, kbeg, kend, split_len, static_cast<int>(row_tiles), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  flash_merge_kernel<T><<<static_cast<unsigned>(merge_blocks), kMergeThreads, 0,
                             stream>>>(
      part, o, static_cast<size_t>(total_rows), d, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v,
               const void* q_offsets, int q_offset_scalar, void* out,
               void* scratch, int batch, int sq, int skv, int heads,
               int kv_heads, int causal, int window, int kbeg, int kend,
               int n_splits, int split_len, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, q_offsets, q_offset_scalar, out, scratch,
                        batch, sq, skv, heads, kv_heads, d, causal, window,
                        kbeg, kend, n_splits, split_len, scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, q_offsets, q_offset_scalar, out, scratch,
                        batch, sq, skv, heads, kv_heads, d, causal, window,
                        kbeg, kend, n_splits, split_len, scale, stream);
  return launch<T, 256>(q, k, v, q_offsets, q_offset_scalar, out, scratch,
                      batch, sq, skv, heads, kv_heads, d, causal, window,
                      kbeg, kend, n_splits, split_len, scale, stream);
}

}  // namespace

// The key range [kbeg, kend) is cut into n_splits pieces of split_len keys;
// with n_splits > 1, scratch holds n_splits * B * Sq * H * (D + 2) floats
// (the partial outputs, then the (m, l) pairs).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const void* q_offsets, int q_offset_scalar,
                                 void* out, void* scratch, int batch, int sq,
                                 int skv, int heads, int kv_heads, int d,
                                 int causal, int window, int kbeg, int kend,
                                 int n_splits, int split_len, float scale,
                                 int dtype, void* stream) {
  if (batch < 0 || sq < 0 || skv < 0 || d < 1 || d > kMaxDim || kv_heads < 1 ||
      heads < kv_heads || heads % kv_heads != 0 || n_splits < 1 ||
      n_splits > 65535 || split_len < 1 || (n_splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_dim<float>(d, q, k, v, q_offsets, q_offset_scalar, out,
                             scratch, batch, sq, skv, heads, kv_heads, causal,
                             window, kbeg, kend, n_splits, split_len, scale, st);
  if (dtype == kDtypeBF16)
    return launch_dim<__nv_bfloat16>(d, q, k, v, q_offsets, q_offset_scalar,
                                     out, scratch, batch, sq, skv, heads,
                                     kv_heads, causal, window, kbeg, kend,
                                     n_splits, split_len, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
