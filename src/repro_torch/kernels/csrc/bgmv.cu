// Batched-gather matrix-vector product (BGMV) for multi-LoRA decode:
//
//     y[i] = x[i] @ A[slot(i)] @ B[slot(i)]        i = 0..B-1
//
// x: (B, d_in), A: (S, d_in, R), B: (S, R, d_out), idx: (B,) int32, y:
// (B, d_out); float32 or bfloat16 storage, float32 accumulation, y in
// x's type. The caller folds the rank mask into A and applies the per-slot
// scale alpha/r_eff afterwards (serve/engine.py::_apply_slab_lora).
// slot(i) is idx[i] taken the reference's way: a negative slot counts from
// the end (S is added), then it is clamped to [0, S - 1].
//
// Replaces the TPU kernel src/repro/kernels/bgmv.py::bgmv (line 43), which
// steered its DMA at A[idx[i]] / B[idx[i]] through scalar-prefetched
// indices and padded R to 128 lanes. Here each block loads its own slot
// index and masks the ragged rank, row and column edges itself; no padding.
//
// Bound on the H100: bytes. Per row the kernel must read d_in*R + R*d_out
// adapter values and does two multiply-adds per value, far below the ~20
// flop/byte (float32) ridge. At Gemma-2B's decode (B 8, 4 slots, R 8,
// d_in 2048, float32; x and y once, the 4 slots' A and B once) that is
// 0.000196 ms for d_out 2048 (q, o) and 0.000110 ms for d_out 256 (k, v)
// at 3.35 TB/s: far below a launch (~0.0011 ms), so the time is a chain of
// latencies (the launch, idx, one pass of loads, the sums, the merge), and
// the design counts round trips.
//
// Design: one launch of B x n_splits blocks of 256 threads in thread block
// clusters of n_splits (kernels/bgmv.py::plan_bgmv, at most 8, from the
// card's cluster capacity): block c of a row's cluster sums slab c of
// d_in's rows and writes share c of d_out's columns. Each thread issues its
// 16-byte loads of x's first pass before it knows the slot; once it has
// read idx[row], its loads of B's first kBRows rank rows and then a whole
// pass of A: kLoads 16-byte loads in flight, a lane on V ranks of a row (V
// = 4 float32 or 8 bfloat16), neighbouring lanes on neighbouring 16 bytes.
// x goes through shared memory as float32 (double-buffered, one barrier a
// pass). The lanes of the same ranks sum by warp shuffles, the warps in
// warp order in shared memory. The slabs meet over distributed shared
// memory: each block stores its R sums into row c of every member's C x R
// array (a barrier arrived at on entry has made sure every member
// started), one cluster barrier follows, and every block adds the C rows
// in slab order 0..C-1 from its own shared memory: the same xa in every
// block, no scratch, no atomics, the same bits on a second call, and no
// block reads another's memory after the barrier, so none waits for
// another to exit. Phase two: P lanes share a vector of V columns, lane q
// taking ranks q, q + P, ..., so that a lane holds at most kBRows rank rows
// (all loaded before xa is known where they fit); the P lanes sum by
// shuffles in a fixed order and one writes the vector (a 16-byte store).
// Element loads and stores take the ragged or unaligned cases with the same
// arithmetic.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kLoads = 8;      // 16-byte loads of A a thread has in flight
constexpr int kBRows = 8;      // B rank rows a lane has in flight
// the launcher's vec bits: 16-byte loads of x, of A's rows, of B and y
enum { kVecX = 1, kVecA = 2, kVecB = 4 };

// values of T in 16 bytes
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Value c (a constant once unrolled) of a 16-byte vector of T, as float32.
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int c) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(v, c));
  } else {
    const unsigned w = word(v, c >> 1);
    return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The kVec<T> values at p, zero past n (nothing is read for n <= 0): one
// 16-byte load with vec (p 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int n, bool vec) {
  constexpr int V = kVec<T>;
  if (n <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && n >= V) return *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (c < n) {
      if constexpr (sizeof(T) == 4) w[c] = bits(p[c]);
      else w[c >> 1] |= bits(p[c]) << ((c & 1) * 16);
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store kVec<T> values rounded to T, those below n (vec: one 16-byte store).
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[kVec<T>],
                                          int n, bool vec) {
  constexpr int V = kVec<T>;
  if (vec && n >= V) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4)
        w[i] = bits(v[i]);
      else
        w[i] = bits(__float2bfloat16(v[2 * i]))
               | (bits(__float2bfloat16(v[2 * i + 1])) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (c < n) p[c] = from_f32<T>(v[c]);
}

template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ b, const int* __restrict__ idx,
            T* __restrict__ y, int d_in, int r, int d_out, int num_slots,
            int n_splits, int rows_per_split, int cols_per_split, int vec) {
  constexpr int V = kVec<T>;
  static_assert(RMAX % V == 0, "a rank template holds whole vectors");
  constexpr int kLanes = RMAX / V;            // lanes along a row of A
  constexpr int kGroups = kThreads / kLanes;  // rows of A a load step
  constexpr int kPass = kGroups * kLoads;     // rows of A a pass
  // x vectors a thread stages a pass
  constexpr int kXv = (kPass + kThreads * V - 1) / (kThreads * V);
  __shared__ __align__(16) float xs[2][kPass];  // x's pass, double-buffered
  __shared__ float red[kWarps][RMAX];           // the warps' sums
  __shared__ float recv[kMaxSplits][RMAX];      // the cluster's, slab z in z
  __shared__ float xa[RMAX];                    // the row's merged xa

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the cluster spans n_splits consecutive blocks of grid x: its blocks
  // share a batch row, and a block's rank in it is its slab
  const int split = blockIdx.x % n_splits, row = blockIdx.x / n_splits;
  const bool vx = vec & kVecX, va = vec & kVecA, vb = vec & kVecB;
  // a member's shared memory may be written only once every member has
  // started: arrive now, wait before the first such store
  if (n_splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lo = split * rows_per_split, hi = min(d_in, lo + rows_per_split);
  const T* xr = x + static_cast<size_t>(row) * d_in;
  // x does not depend on the slot: this thread's vectors of its first
  // pass now (vector u at row xo + u * kThreads * V of the pass)
  const int xo = tid * V;
  uint4 xv[kXv];
#pragma unroll
  for (int u = 0; u < kXv; ++u) {
    const int e = xo + u * kThreads * V;
    xv[u] = load_vec(xr + lo + e, e < kPass ? hi - lo - e : 0, vx);
  }
  int slot = idx[row];  // the reference's rule: from the end, then clamped
  if (slot < 0) slot += num_slots;
  slot = min(max(slot, 0), num_slots - 1);

  // phase two's lanes: P consecutive lanes of a warp (a power of two, at
  // most 32) share a vector of V columns, lane q taking ranks q, q + P,
  // ...: as few as hold the ranks in one batch of kBRows rank rows a lane
  // (with element loads of B, one rank row a lane, to share out the scalar
  // loads), as far as the block's column vectors leave room for them
  const int c_lo = split * cols_per_split;
  const int c_hi = min(d_out, c_lo + cols_per_split);
  const int want = min(32, vb ? (r + kBRows - 1) / kBRows : r);
  int lg = 0;
  while ((1 << lg) < want && (cols_per_split / V) << (lg + 1) <= kThreads) ++lg;
  const int q = tid & ((1 << lg) - 1);
  const int col0 = c_lo + (tid >> lg) * V;
  const int col_step = (kThreads >> lg) * V;
  // their first rank rows, loaded now: they do not depend on xa
  const T* bs = b + static_cast<size_t>(slot) * r * d_out;
  uint4 bv[kBRows];
#pragma unroll
  for (int j = 0; j < kBRows; ++j) {
    const int k = q + (j << lg);
    bv[j] = load_vec(bs + static_cast<size_t>(k) * d_out + col0,
                     k < r ? c_hi - col0 : 0, vb);
  }

  // phase one: this block's slab, a pass of kLoads row steps at a time;
  // lane (g, kb) takes ranks kb..kb+V of rows g, g + kGroups, ...
  const int kb = (tid % kLanes) * V, g = tid / kLanes;
  const T* as = a + static_cast<size_t>(slot) * d_in * r + kb;
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  int buf = 0;
  for (int p0 = lo; p0 < hi; p0 += kPass, buf ^= 1) {
    uint4 av[kLoads];  // every load of the pass issued before any is used
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int rr = p0 + g + j * kGroups;
      av[j] = load_vec(as + static_cast<size_t>(rr) * r, rr < hi ? r - kb : 0,
                       va);
    }
#pragma unroll
    for (int u = 0; u < kXv; ++u) {
      const int e = xo + u * kThreads * V;
      if (e < kPass) {
#pragma unroll
        for (int c = 0; c < V; c += 4)
          *reinterpret_cast<float4*>(&xs[buf][e + c]) = make_float4(
              elem<T>(xv[u], c), elem<T>(xv[u], c + 1), elem<T>(xv[u], c + 2),
              elem<T>(xv[u], c + 3));
      }
    }
    __syncthreads();  // the pass's x is staged (and the last pass's read)
    const int next = p0 + kPass;  // the next pass's x, before the sums
    if (next < hi) {
#pragma unroll
      for (int u = 0; u < kXv; ++u) {
        const int e = xo + u * kThreads * V;
        xv[u] = load_vec(xr + next + e, e < kPass ? hi - next - e : 0, vx);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const float xf = xs[buf][g + j * kGroups];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = fmaf(xf, elem<T>(av[j], c), acc[c]);
    }
  }
  // the lanes of the same ranks (lane mod kLanes), then the warps in order
#pragma unroll
  for (int o = 16; o >= kLanes; o >>= 1)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  if (lane < kLanes) {
#pragma unroll
    for (int c = 0; c < V; ++c) red[warp][kb + c] = acc[c];
  }
  __syncthreads();
  float v = 0.f;
  if (tid < r) {
    v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][tid];
  }
  if (n_splits > 1) {
    // the block's sums go to every member of the cluster (itself
    // included), into row `split` of its recv; one cluster barrier, after
    // which no block touches another's memory, so any block may exit
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (tid < r) {
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < n_splits) cluster.map_shared_rank(&recv[split][tid], z)[0] = v;
    }
    cluster.sync();
    if (tid < r) {  // the slabs in slab order: the same xa in every block
      v = recv[0][tid];
      for (int z = 1; z < n_splits; ++z) v += recv[z][tid];
    }
  }
  if (tid < r) xa[tid] = v;
  __syncthreads();

  // phase two: this block's columns, a step of col_step at a time (the
  // same steps and batches of rank rows in every lane: they meet by
  // shuffles); the P lanes of a column vector sum in a fixed order
  T* yr = y + static_cast<size_t>(row) * d_out;
  const int steps = (cols_per_split + col_step - 1) / col_step;
  for (int st = 0; st < steps; ++st) {
    const int col = col0 + st * col_step;
    float o[V];
#pragma unroll
    for (int c = 0; c < V; ++c) o[c] = 0.f;
    for (int k0 = 0; k0 < r; k0 += kBRows << lg) {
      if (st > 0 || k0 > 0) {  // the first batch was loaded before xa
#pragma unroll
        for (int j = 0; j < kBRows; ++j) {
          const int k = k0 + q + (j << lg);
          bv[j] = load_vec(bs + static_cast<size_t>(k) * d_out + col,
                           k < r ? c_hi - col : 0, vb);
        }
      }
#pragma unroll
      for (int j = 0; j < kBRows; ++j) {
        const int k = k0 + q + (j << lg);
        const float xk = k < r ? xa[k] : 0.f;
#pragma unroll
        for (int c = 0; c < V; ++c) o[c] = fmaf(xk, elem<T>(bv[j], c), o[c]);
      }
    }
    for (int off = 1; off < (1 << lg); off <<= 1)
#pragma unroll
      for (int c = 0; c < V; ++c) o[c] += __shfl_xor_sync(0xffffffffu, o[c], off);
    if (q == 0) store_vec<T>(yr + col, o, c_hi - col, vb);
  }
}

// One cluster of n_splits blocks along x per batch row; *cluster backs
// cfg.attrs.
inline cudaLaunchConfig_t config(int blocks, int n_splits, cudaStream_t st,
                                 cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = n_splits;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int RMAX>
int launch(const void* x, const void* a, const void* b, const void* idx,
           void* y, int batch, int d_in, int r, int d_out, int num_slots,
           int n_splits, int rows_per_split, int cols_per_split, int vec,
           cudaStream_t st) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config(batch * n_splits, n_splits, st, &cluster);
  cudaLaunchKernelEx(&cfg, bgmv_kernel<T, RMAX>, static_cast<const T*>(x),
                     static_cast<const T*>(a), static_cast<const T*>(b),
                     static_cast<const int*>(idx), static_cast<T*>(y), d_in,
                     r, d_out, num_slots, n_splits, rows_per_split,
                     cols_per_split, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rank(const void* x, const void* a, const void* b, const void* idx,
                void* y, int batch, int d_in, int r, int d_out, int num_slots,
                int n_splits, int rows_per_split, int cols_per_split, int vec,
                cudaStream_t st) {
#define BGMV_ARGS x, a, b, idx, y, batch, d_in, r, d_out, num_slots, \
    n_splits, rows_per_split, cols_per_split, vec, st
  if (r <= 8) return launch<T, 8>(BGMV_ARGS);
  if (r <= 16) return launch<T, 16>(BGMV_ARGS);
  if (r <= 32) return launch<T, 32>(BGMV_ARGS);
  return launch<T, 64>(BGMV_ARGS);
#undef BGMV_ARGS
}

// Blocks of bgmv_kernel<T, RMAX> the card holds at once in clusters of
// n_splits, or a negative CUDA error.
template <typename T, int RMAX>
int slots(int n_splits) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config(n_splits, n_splits, nullptr, &cluster);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, bgmv_kernel<T, RMAX>, &cfg);
  return err == cudaSuccess ? clusters * n_splits : -static_cast<int>(err);
}

template <typename T>
int slots_rank(int n_splits, int r) {
  if (r <= 8) return slots<T, 8>(n_splits);
  if (r <= 16) return slots<T, 16>(n_splits);
  if (r <= 32) return slots<T, 32>(n_splits);
  return slots<T, 64>(n_splits);
}

inline bool aligned(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// whether n_splits parts of `per` cover `total` with none empty
inline bool covers(int total, int n_splits, int per) {
  if (total == 0) return n_splits == 1;
  return per > 0 && static_cast<long long>(n_splits) * per >= total
         && static_cast<long long>(n_splits - 1) * per < total;
}

}  // namespace

// The blocks of the bgmv kernel for rank r (its template: 8, 16, 32 or 64)
// and dtype that the card holds at once in clusters of n_splits (1..8):
// cudaOccupancyMaxActiveClusters x n_splits. The plan (kernels/bgmv.py::
// plan_bgmv) counts its waves with it. Negative: a CUDA error.
extern "C" int bgmv_slots(int n_splits, int r, int dtype) {
  if (n_splits < 1 || n_splits > kMaxSplits || r < 1 || r > 64)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kDtypeF32) return slots_rank<float>(n_splits, r);
  if (dtype == kDtypeBF16) return slots_rank<__nv_bfloat16>(n_splits, r);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// y (B, d_out) = x @ A[slot] @ B[slot]. The plan (kernels/bgmv.py::
// plan_bgmv): n_splits blocks a row (one cluster), slabs of rows_per_split
// rows of d_in and shares of cols_per_split columns of d_out, both
// multiples of 8. vec: the kVec* bits, each only where its widths are
// multiples of the 16-byte vector and its operands aligned.
extern "C" int bgmv_launch(const void* x, const void* a, const void* b,
                           const void* idx, void* y, int batch, int d_in,
                           int r, int d_out, int num_slots, int n_splits,
                           int rows_per_split, int cols_per_split, int vec,
                           int dtype, void* stream) {
  if (r < 1 || r > 64 || batch < 0 || d_in < 0 || d_out < 0
      || (dtype != kDtypeF32 && dtype != kDtypeBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d_out == 0) return 0;
  const int per = dtype == kDtypeF32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (num_slots < 1 || n_splits < 1 || n_splits > kMaxSplits
      || batch > 0x7fffffff / n_splits || rows_per_split % 8 != 0
      || cols_per_split % 8 != 0 || !covers(d_in, n_splits, rows_per_split)
      || static_cast<long long>(n_splits) * cols_per_split < d_out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((vec & kVecX) && (d_in % per != 0 || !aligned(x)))
      || ((vec & kVecA) && (r % per != 0 || !aligned(a)))
      || ((vec & kVecB) && (d_out % per != 0 || !aligned(b) || !aligned(y))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_rank<float>(x, a, b, idx, y, batch, d_in, r, d_out,
                              num_slots, n_splits, rows_per_split,
                              cols_per_split, vec, st);
  return launch_rank<__nv_bfloat16>(x, a, b, idx, y, batch, d_in, r, d_out,
                                    num_slots, n_splits, rows_per_split,
                                    cols_per_split, vec, st);
}
