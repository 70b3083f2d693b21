// Fused LoRA matmul, forward and backward, for client training:
//
//     forward   y  = x @ W0 + s * (x @ A) @ B            (xa = x @ A kept)
//     dx        dx = dy @ W0^T + s * (dy @ B^T) @ A^T     (g = dy @ B^T kept)
//     dA, dB    dA = s * x^T g,   dB = s * xa^T dy
//
// x: (M, K), W0: (K, N), A: (K, R), B: (R, N), dy: (M, N); the forward
// takes float32 or bfloat16 storage, the backward float32 only (bf16
// training is not ported); float32 accumulation, outputs in the input
// type; xa and g are float32 (M, R), unscaled; s is a float32 scalar the
// kernels read from device memory (alpha / r_eff, computed on the device
// by the caller).
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py::lora_matmul
// (src/repro/kernels/lora_matmul.py:51), whose grid walks K sequentially
// and accumulates x@W0 and the bottleneck x@A in VMEM scratch from the
// same x block, so x is read from HBM once for both products; the (R, bn)
// B tile closes the low-rank path on the last K step. It had no backward:
// the reference trains through plain jnp. Here dx is the same design with
// W0, A and B read transposed in place, and dA/dB is one more kernel. No
// padding: every kernel masks its own ragged M, K, N and rank edges.
//
// Bound on the H100 at the training path's shape (M 512, K = N = 1024,
// R 8, float32, which stays on CUDA cores: no TF32, no tensor cores): the
// forward and dx each do 2MKN + 2MR(K + N) ~ 1.09 GFLOP, 0.0163 ms at 67
// TFLOP/s, against ~8.1 MB moved, 0.0024 ms at 3.35 TB/s: bound by
// operations. dA/dB does 2MR(K + N) ~ 17 MFLOP over ~4 MB (x, dy, xa, g
// read once): bound by bytes, 0.0013 ms.
//
// Design of the forward and dx (PERF.md's findings hold the measurements).
// 1. The bottleneck once per row, not once per output tile:
//    lora_xa_kernel (xa = x @ A) and lora_g_kernel (g = dy @ B^T, which is
//    also the whole of the g-only path) give each input row a block of 128
//    threads that stride over its reduction with coalesced loads, up to 8
//    strides' loads in flight, RMAX float32 sums a thread (ranks templated
//    8/16/32/64), a butterfly reduce-scatter in each warp and the four
//    warps summed in a fixed order: M blocks, so the card fills at M 512.
//    On the H100 the input (2 MB) stays in the 50 MB L2 for the GEMM that
//    follows, so the TPU kernel's reason to fuse costs an L2 re-read here.
// 2. One float32 tile GEMM for both (lora_gemm), parameterised by operand
//    layout: an operand is either contiguous along the reduction (x, dy,
//    and W0^T in dx) or along the output (W0 in the forward; x^T and dy in
//    a dW0 = x^T dy). The low-rank term is R more reduction steps of the
//    same loop, [in | s * bottleneck] against [W ; up], run by the split
//    that owns depth 0. A block owns a 64 x 64 output tile with four
//    slices of 64 threads; each slice holds the whole tile, 8 x 8 outputs
//    a thread, and takes a quarter of the depths of every stage, so 256
//    threads share one tile and two blocks fill an SM with 16 warps. A
//    thread reads its 8 rows and 8 columns of one depth with four 16-byte
//    shared loads and does 64 multiply-adds: 4 per float loaded (a 16-byte
//    shared load costs a warp 4 cycles). Both operands sit k-major in
//    shared memory; a warp's threads are 4 x 8, so each A-side load is
//    shared by 8 lanes and each B-side load by 4, in distinct banks. The
//    store that transposes a reduction-contiguous operand puts a warp's
//    lanes on 32 consecutive output rows of one depth: free of bank
//    conflicts without padding. At the end the slices meet in shared
//    memory once: each owns a quarter of the tile's rows, sums the four
//    slices' values in slice order and stores them.
// 3. Loads overlap the products through a register-staged double buffer:
//    16-byte global loads of stage s+1 are issued before stage s's
//    multiply-adds and stored to the other shared buffer after them, one
//    barrier a stage. The same staging converts bf16 and transposes, so
//    dx's W0^T costs what the forward's W0 does. 16-byte loads need K and
//    N multiples of 16 / sizeof(T) and 16-byte aligned operands; otherwise
//    the launcher picks the instantiation with element loads (same tiles,
//    same order of sums).
// 4. A host-side plan (kernels/lora_matmul.py::plan_splits, from ints and
//    the SM count) splits the reduction where the output has too few
//    tiles to give every SM two blocks: the fewest waves x depth a split,
//    the port's rule (flash_attn.py::plan_splits); 2 splits at (512, 1024,
//    1024), 256 blocks; 8 at M = 1 and N 2048. Split partials go to
//    float32 scratch and lora_fwd_merge_kernel / lora_dx_merge_kernel sum
//    them in split order: no atomics, the same inputs give the same bits.
// lora_grad_ab_kernel: the two skinny reductions over M. Each block owns
// 32 columns of x (for dA) or of dy (for dB): a lane per column, eight
// warps splitting the rows, RMAX float32 partial sums per thread, the
// other factor's row broadcast across the warp; the eight partials are
// summed in shared memory in a fixed order (deterministic, no atomics).
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. the bottleneck: out (M, R) = in (M, K) @ D (K, R), one block a row
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 128;
constexpr int kRowWarps = kRowThreads / 32;

// One step of a butterfly reduce-scatter over N values a lane: lanes whose
// bit H is set keep the upper H values, the others the lower, and each adds
// its partner's copy of what it kept.
template <int N, int H>
__device__ __forceinline__ void halve(float (&x)[N], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? x[i] : x[i + H];
    const float keep = upper ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// N (a power of two up to 32) values a lane; afterwards every lane holds
// the warp's sum of value lane % N, in a fixed order.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&x)[N], int lane) {
  if constexpr (N >= 32) halve<N, 16>(x, lane);
  if constexpr (N >= 16) halve<N, 8>(x, lane);
  if constexpr (N >= 8) halve<N, 4>(x, lane);
  if constexpr (N >= 4) halve<N, 2>(x, lane);
  if constexpr (N >= 2) halve<N, 1>(x, lane);
#pragma unroll
  for (int o = N; o < 32; o <<= 1) x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
  return x[0];
}

// DOWN_T: D[k, r] = down[r * K + k] (B stored (R, N), for g = dy @ B^T);
// else down[k * R + r] (A stored (K, R), for xa = x @ A).
template <typename T, int RMAX, bool DOWN_T>
__device__ __forceinline__ void bottleneck_row(const T* __restrict__ in,
                                               const T* __restrict__ down,
                                               float* __restrict__ out, int K,
                                               int R) {
  constexpr int kChunk = RMAX < 32 ? RMAX : 32;
  __shared__ float s_red[kRowWarps][RMAX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m = blockIdx.x;
  const T* row = in + m * K;
  // A's row of R float32 values by 16-byte loads where they are whole
  const bool vec = !DOWN_T && sizeof(T) == 4 && R % 4 == 0 && aligned16(down);
  // U strides of the row in flight at once: their loads are issued before
  // their multiply-adds (U * RMAX values in registers)
  constexpr int U = RMAX <= 8 ? 8 : 64 / RMAX;
  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
  for (int k0 = tid; k0 < K; k0 += U * kRowThreads) {
    float xv[U], dv[U][RMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kRowThreads;
      const bool in_k = k < K;
      xv[u] = in_k ? to_f32(row[k]) : 0.f;
      if (vec) {
        const T* d = down + static_cast<size_t>(k) * R;
#pragma unroll
        for (int r = 0; r < RMAX; r += 4) {
          const float4 v = in_k && r < R ? load4(d + r, 4, true)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          dv[u][r] = v.x;
          dv[u][r + 1] = v.y;
          dv[u][r + 2] = v.z;
          dv[u][r + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          dv[u][r] = in_k && r < R
                         ? to_f32(DOWN_T ? down[static_cast<size_t>(r) * K + k]
                                         : down[static_cast<size_t>(k) * R + r])
                         : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < RMAX; ++r) acc[r] = fmaf(xv[u], dv[u][r], acc[r]);
  }
#pragma unroll
  for (int c = 0; c < RMAX; c += kChunk) {
    float part[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) part[i] = acc[c + i];
    const float v = reduce_scatter<kChunk>(part, lane);
    if (lane < kChunk) s_red[warp][c + lane] = v;
  }
  __syncthreads();
  if (tid < R) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) v += s_red[w][tid];
    out[m * R + tid] = v;
  }
}

// xa = x @ A, the forward's bottleneck
template <typename T, int RMAX>
__global__ void __launch_bounds__(kRowThreads)
lora_xa_kernel(const T* __restrict__ x, const T* __restrict__ a,
               float* __restrict__ xa, int K, int R) {
  bottleneck_row<T, RMAX, false>(x, a, xa, K, R);
}

// g = dy @ B^T, dx's bottleneck (and the whole of the g-only path)
template <int RMAX>
__global__ void __launch_bounds__(kRowThreads)
lora_g_kernel(const float* __restrict__ dy, const float* __restrict__ b,
              float* __restrict__ g, int N, int R) {
  bottleneck_row<float, RMAX, true>(dy, b, g, N, R);
}

// ---------------------------------------------------------------------------
// 2. the tile GEMM: out (M, N) = P (M, K) @ Q (K, N) + (s bt) (M, R) @ U (R, N)
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int TN_, int BK_, int SLICES_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = 8, TN = TN_;
  static constexpr int SLICES = SLICES_;              // warp groups along k
  static constexpr int TY = BM / TM, TX = BN / TN;    // a slice's threads along m, n
  static constexpr int kSliceThreads = TY * TX;
  static constexpr int kThreads = kSliceThreads * SLICES;
  static constexpr int KS = BK / SLICES;              // a slice's depths of a stage
  static constexpr int kOwnRows = TM / SLICES;        // a thread's rows each slice sums
  static constexpr int kStageFloats = 2 * BK * (BM + BN);   // two stages of P and Q
  static constexpr int kMeetFloats = (SLICES - 1) * BM * BN;
  static constexpr int kSmemFloats =
      kMeetFloats > kStageFloats ? kMeetFloats : kStageFloats;
  static_assert(TY % 4 == 0 && TX % 8 == 0, "warps are 4 x 8 threads");
  static_assert(TN == 4 || TN == 8, "a thread's columns: 1 or 2 vectors of 4");
  static_assert(BK % SLICES == 0 && TM % SLICES == 0, "whole depths and rows a slice");
  static_assert(kSmemFloats * 4 <= 48 * 1024, "static shared memory");
};

// The tile both kernels use (kernels/lora_matmul.py::TILE and DEPTH): 64 x
// 64 outputs, 8 x 8 a thread, stages 16 deep, four slices: 256 threads.
using Tile = TileCfg<64, 64, 8, 16, 4>;
// Two blocks an SM (kernels/lora_matmul.py::BLOCKS_PER_SM): ptxas keeps a
// thread at 128 registers or fewer, so two blocks take the register file.
constexpr int kBlocksPerSm = 2;

// One operand's (EXT x BK) stage: element (e, k), e along the output (rows
// of the product for P, columns for Q), k along the reduction. KMAJOR: the
// operand is stored contiguous along k (element at base[e * ld + k]);
// otherwise along e (base[k * ld + e]). A thread holds CHUNKS chunks of CH
// elements (16 bytes) contiguous in storage, as float32. In shared memory
// the stage is k-major: s[k * EXT + e].
template <typename T, int EXT, int BK, int THREADS, bool KMAJOR, bool VEC>
struct Stager {
  static constexpr int CH = 16 / static_cast<int>(sizeof(T));
  static constexpr int TOTAL = EXT * BK / CH;                // chunks a stage
  static constexpr int CHUNKS = (TOTAL + THREADS - 1) / THREADS;
  static_assert(KMAJOR ? BK % CH == 0 : EXT % CH == 0, "whole chunks a row");
  float v[CHUNKS][CH];

  // chunk c of this thread: its first element (e, k), or false past the
  // stage. KMAJOR: lanes on consecutive e at one k, so the transposing store
  // is conflict-free.
  static __device__ __forceinline__ bool coords(int c, int& e, int& k) {
    const int idx = static_cast<int>(threadIdx.x) + c * THREADS;
    if (KMAJOR) {
      e = idx % EXT;
      k = idx / EXT * CH;
    } else {
      e = idx % (EXT / CH) * CH;
      k = idx / (EXT / CH);
    }
    return TOTAL % THREADS == 0 || idx < TOTAL;
  }

  // VEC: the stored dimension's extent (k_end for KMAJOR, e_end otherwise)
  // is a multiple of CH, so a chunk is whole or out.
  __device__ __forceinline__ void load(const T* __restrict__ base, int ld,
                                       int e0, int e_end, int k0, int k_end) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      int e, k;
      if (!coords(c, e, k)) break;
      const int ge = e0 + e, gk = k0 + k;
      if (VEC) {
        if (ge < e_end && gk < k_end) {
          const T* p = base + (KMAJOR ? static_cast<size_t>(ge) * ld + gk
                                      : static_cast<size_t>(gk) * ld + ge);
          if constexpr (sizeof(T) == 4) {
            const float4 f = *reinterpret_cast<const float4*>(p);
            v[c][0] = f.x;
            v[c][1] = f.y;
            v[c][2] = f.z;
            v[c][3] = f.w;
          } else {
            const uint4 raw = *reinterpret_cast<const uint4*>(p);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              v[c][2 * j] = f.x;
              v[c][2 * j + 1] = f.y;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < CH; ++j) v[c][j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int ee = KMAJOR ? ge : ge + j, kk = KMAJOR ? gk + j : gk;
          v[c][j] = ee < e_end && kk < k_end
                        ? to_f32(base[KMAJOR ? static_cast<size_t>(ee) * ld + kk
                                             : static_cast<size_t>(kk) * ld + ee])
                        : 0.f;
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ s) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      int e, k;
      if (!coords(c, e, k)) break;
      if (KMAJOR) {
#pragma unroll
        for (int j = 0; j < CH; ++j) s[(k + j) * EXT + e] = v[c][j];
      } else {
#pragma unroll
        for (int j = 0; j < CH; j += 4)
          *reinterpret_cast<float4*>(s + k * EXT + e + j) =
              make_float4(v[c][j], v[c][j + 1], v[c][j + 2], v[c][j + 3]);
      }
    }
  }
};

// One block: the (BM, BN) output tile (blockIdx.y, blockIdx.x) over the
// reduction range of split blockIdx.z, [z * kps, min(K, (z + 1) * kps)).
// P is in (M, K) (PK) or stored (K, M); Q is w stored (N, K) (QK) or
// (K, N). The low-rank term, in split 0 only: bt (M, R) float32, scaled by
// *scale as it is staged, against up stored (N, R) (QK) or (R, N). The
// block's SLICES warp groups share each stage, slice q taking its depths
// [q KS, (q + 1) KS); at the end each slice sums its kOwnRows of every
// thread's rows over the slices, in slice order. With one split the block
// writes out (T); with more, its float32 partial goes to part[z] (M, N)
// and the merge kernel sums them.
template <class C, typename T, bool PK, bool QK, bool VEC>
__device__ __forceinline__ void lora_gemm(
    const T* __restrict__ in, const T* __restrict__ w,
    const float* __restrict__ bt, const T* __restrict__ up,
    const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ part, int M, int N, int K, int R, int kps) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  __shared__ __align__(16) float smem[C::kSmemFloats];
  float* const s_p = smem;                // two stages of (BK, BM)
  float* const s_q = smem + 2 * BK * BM;  // two stages of (BK, BN)
  const int tid = threadIdx.x;
  const int slice = tid / C::kSliceThreads, t = tid % C::kSliceThreads;
  const int lane = t & 31, warp = t >> 5;
  const int ty = warp / (C::TX / 8) * 4 + (lane >> 3);
  const int tx = warp % (C::TX / 8) * 8 + (lane & 7);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int k_lo = split * kps, k_hi = min(K, k_lo + kps);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // a thread's rows: ci * TY * 4 + ty * 4 + {0..3}; columns: cj * TX * 4 +
  // tx * 4 + {0..3}; depths: its slice's of the stage
  auto compute = [&](const float* __restrict__ sp, const float* __restrict__ sq) {
#pragma unroll
    for (int u = 0; u < C::KS; ++u) {
      const int kk = slice * C::KS + u;
      float a[TM], b[TN];
#pragma unroll
      for (int ci = 0; ci < TM / 4; ++ci) {
        const float4 v = *reinterpret_cast<const float4*>(sp + kk * BM + ci * C::TY * 4 + ty * 4);
        a[4 * ci] = v.x;
        a[4 * ci + 1] = v.y;
        a[4 * ci + 2] = v.z;
        a[4 * ci + 3] = v.w;
      }
#pragma unroll
      for (int cj = 0; cj < TN / 4; ++cj) {
        const float4 v = *reinterpret_cast<const float4*>(sq + kk * BN + cj * C::TX * 4 + tx * 4);
        b[4 * cj] = v.x;
        b[4 * cj + 1] = v.y;
        b[4 * cj + 2] = v.z;
        b[4 * cj + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  Stager<T, BM, BK, C::kThreads, PK, VEC> p;
  Stager<T, BN, BK, C::kThreads, QK, VEC> q;
  const int ldp = PK ? K : M, ldq = QK ? K : N;
  const int stages = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  if (stages > 0) {
    p.load(in, ldp, m0, M, k_lo, k_hi);
    q.load(w, ldq, n0, N, k_lo, k_hi);
    p.store(s_p);
    q.store(s_q);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < stages;
      if (more) {  // stage s+1's loads run under stage s's products
        p.load(in, ldp, m0, M, k_lo + (s + 1) * BK, k_hi);
        q.load(w, ldq, n0, N, k_lo + (s + 1) * BK, k_hi);
      }
      compute(s_p + buf * BK * BM, s_q + buf * BK * BN);
      if (more) {
        p.store(s_p + (buf ^ 1) * BK * BM);
        q.store(s_q + (buf ^ 1) * BK * BN);
      }
      __syncthreads();  // stage s+1 visible; every thread is done with stage s
    }
  }

  if (split == 0) {  // the low-rank term: R more reduction steps
    const float s = *scale;
    for (int r0 = 0; r0 < R; r0 += BK) {
      for (int e = tid; e < BK * BM; e += C::kThreads) {
        const int r = r0 + e / BM, m = m0 + e % BM;
        s_p[e] = r < R && m < M ? s * bt[static_cast<size_t>(m) * R + r] : 0.f;
      }
      for (int e = tid; e < BK * BN; e += C::kThreads) {
        const int r = r0 + e / BN, n = n0 + e % BN;
        float v = 0.f;
        if (r < R && n < N)
          v = to_f32(QK ? up[static_cast<size_t>(n) * R + r]
                        : up[static_cast<size_t>(r) * N + n]);
        s_q[e] = v;
      }
      __syncthreads();
      compute(s_p, s_q);
      __syncthreads();
    }
  }

  // The slices meet once: slice q owns rows [q kOwnRows, (q + 1) kOwnRows)
  // of each thread's TM; every slice leaves the rows it does not own in
  // shared memory (a region per owner and sender), and each owner sums the
  // SLICES values of its rows in slice order. Register indices stay
  // compile-time constants: the owner test is a predicate.
  constexpr int kOwn = C::kOwnRows;
  constexpr int kRegion = kOwn * TN * C::kSliceThreads;  // one (owner, sender) pair
  auto region = [&](int owner, int sender) {
    return smem + (owner * (C::SLICES - 1) + (sender < owner ? sender : sender - 1)) * kRegion;
  };
  if constexpr (C::SLICES > 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int owner = i / kOwn;
      if (owner == slice) continue;
      float* dst = region(owner, slice) + (i % kOwn) * TN * C::kSliceThreads;
#pragma unroll
      for (int j = 0; j < TN; ++j) dst[j * C::kSliceThreads + t] = acc[i][j];
    }
    __syncthreads();
  }

  const bool whole = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (i / kOwn != slice) continue;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = 0.f;
    if constexpr (C::SLICES > 1) {
#pragma unroll
      for (int src = 0; src < C::SLICES; ++src) {  // slice order
#pragma unroll
        for (int j = 0; j < TN; ++j)
          v[j] += src == slice ? acc[i][j]
                               : region(slice, src)[((i % kOwn) * TN + j) * C::kSliceThreads + t];
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] = acc[i][j];
    }
    const int row = m0 + i / 4 * C::TY * 4 + ty * 4 + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int cj = 0; cj < TN / 4; ++cj) {
      const int col = n0 + cj * C::TX * 4 + tx * 4;
      if (col >= N) continue;
      const float o[4] = {v[4 * cj], v[4 * cj + 1], v[4 * cj + 2], v[4 * cj + 3]};
      if (whole)
        store4<T>(out + static_cast<size_t>(row) * N + col, o, N - col, VEC);
      else
        store4<float>(part + (static_cast<size_t>(split) * M + row) * N + col, o,
                      N - col, VEC);
    }
  }
}

#define LORA_GEMM_ARGS(T)                                                    \
  const T* __restrict__ in, const T* __restrict__ w,                         \
      const float* __restrict__ bt, const T* __restrict__ up,                \
      const float* __restrict__ scale, T* __restrict__ out,                  \
      float* __restrict__ part, int M, int N, int K, int R, int kps
#define LORA_GEMM_PASS in, w, bt, up, scale, out, part, M, N, K, R, kps

// the forward: y = x @ W0 + (s xa) @ B
template <typename T, bool VEC>
__global__ void __launch_bounds__(Tile::kThreads, kBlocksPerSm)
lora_fwd_kernel(LORA_GEMM_ARGS(T)) {
  lora_gemm<Tile, T, true, false, VEC>(LORA_GEMM_PASS);
}

// dx = dy @ W0^T + (s g) @ A^T (float32: the backward)
template <bool VEC>
__global__ void __launch_bounds__(Tile::kThreads, kBlocksPerSm)
lora_dx_kernel(LORA_GEMM_ARGS(float)) {
  lora_gemm<Tile, float, true, true, VEC>(LORA_GEMM_PASS);
}

// The split partials part (n_splits, total) summed in split order: a
// thread per 4 consecutive outputs.
constexpr int kMergeThreads = 256;

template <typename T>
__device__ __forceinline__ void merge_partials(const float* __restrict__ part,
                                               T* __restrict__ out, size_t total,
                                               int n_splits) {
  const size_t e = (static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x) * 4;
  if (e >= total) return;
  const size_t left = total - e;
  const int n = left < 4 ? static_cast<int>(left) : 4;
  const bool vec_in = total % 4 == 0;  // every split's rows start 16-byte aligned
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_splits; ++s) {
    const float4 v = load4(part + s * total + e, n, vec_in);
    x[0] += v.x;
    x[1] += v.y;
    x[2] += v.z;
    x[3] += v.w;
  }
  store4<T>(out + e, x, n, aligned16(out));
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
lora_fwd_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                      size_t total, int n_splits) {
  merge_partials<T>(part, out, total, n_splits);
}

__global__ void __launch_bounds__(kMergeThreads)
lora_dx_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                     size_t total, int n_splits) {
  merge_partials<float>(part, out, total, n_splits);
}

// ---------------------------------------------------------------------------
// 3. dA and dB
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kCols = 32;                  // columns per reduction block
constexpr int kWarps = kThreads / 32;

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
lora_grad_ab_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ xa, const float* __restrict__ dy,
                    const float* __restrict__ scale, float* __restrict__ da,
                    float* __restrict__ db, int M, int K, int N, int R,
                    int blocks_a) {
  // blocks [0, blocks_a): dA[c, r] = s * sum_m x[m, c] g[m, r], c < K;
  // the rest:            dB[r, c] = s * sum_m xa[m, r] dy[m, c], c < N.
  constexpr int kChunk = RMAX < 16 ? RMAX : 16;
  __shared__ float s_red[kWarps][kChunk][kCols + 1];
  const bool is_a = blockIdx.x < blocks_a;   // uniform across the block
  const int c0 = (is_a ? blockIdx.x : blockIdx.x - blocks_a) * kCols;
  const float* p = is_a ? x : dy;
  const float* q = is_a ? g : xa;
  const int C = is_a ? K : N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + lane;

  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
  for (int m = warp; m < M; m += kWarps) {
    const float pv = c < C ? p[static_cast<size_t>(m) * C + c] : 0.f;
    const float* qr = q + static_cast<size_t>(m) * R;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) acc[r] = fmaf(pv, qr[r], acc[r]);
  }

  const float s = *scale;
#pragma unroll
  for (int r0 = 0; r0 < RMAX; r0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s_red[warp][j][lane] = acc[r0 + j];
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kCols; e += kThreads) {
      const int j = e / kCols, l = e % kCols;
      const int r = r0 + j, cc = c0 + l;
      if (r < R && cc < C) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_red[w][j][l];
        v *= s;
        if (is_a) da[static_cast<size_t>(cc) * R + r] = v;
        else db[static_cast<size_t>(r) * N + cc] = v;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline bool host_aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// the bottleneck of every row, for ranks up to RMAX
template <typename T, int RMAX>
void launch_bottleneck(bool trans, const T* in, const T* down, float* out, int m,
                       int k, int r, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (trans) {
      lora_g_kernel<RMAX><<<m, kRowThreads, 0, st>>>(in, down, out, k, r);
      return;
    }
  }
  lora_xa_kernel<T, RMAX><<<m, kRowThreads, 0, st>>>(in, down, out, k, r);
}

template <typename T>
int bottleneck(bool trans, const T* in, const T* down, float* out, int m, int k,
               int r, cudaStream_t st) {
  if (r <= 8) launch_bottleneck<T, 8>(trans, in, down, out, m, k, r, st);
  else if (r <= 16) launch_bottleneck<T, 16>(trans, in, down, out, m, k, r, st);
  else if (r <= 32) launch_bottleneck<T, 32>(trans, in, down, out, m, k, r, st);
  else launch_bottleneck<T, 64>(trans, in, down, out, m, k, r, st);
  return last_error();
}

template <typename T, bool VEC>
void launch_gemm(bool trans, const T* in, const T* w, const float* bt,
                 const T* up, const float* scale, T* out, float* part, int m,
                 int n, int k, int r, int splits, int kps, cudaStream_t st) {
  const dim3 grid((n + Tile::BN - 1) / Tile::BN, (m + Tile::BM - 1) / Tile::BM, splits);
  if constexpr (sizeof(T) == 4) {
    if (trans) {
      lora_dx_kernel<VEC><<<grid, Tile::kThreads, 0, st>>>(
          in, w, bt, up, scale, out, part, m, n, k, r, kps);
      return;
    }
  }
  lora_fwd_kernel<T, VEC><<<grid, Tile::kThreads, 0, st>>>(
      in, w, bt, up, scale, out, part, m, n, k, r, kps);
}

template <typename T>
int run(const void* in_, const void* w_, const void* down_, const void* up_,
        const float* scale, void* out_, float* bt, float* part, int m, int n,
        int k, int r, bool trans, bool base, int splits, int kps, bool vec,
        cudaStream_t st) {
  const T* in = static_cast<const T*>(in_);
  const T* w = static_cast<const T*>(w_);
  const T* up = static_cast<const T*>(up_);
  T* out = static_cast<T*>(out_);
  int err = bottleneck<T>(trans, in, static_cast<const T*>(down_), bt, m, k, r, st);
  if (err != 0 || !base || n == 0) return err;
  if (vec) launch_gemm<T, true>(trans, in, w, bt, up, scale, out, part, m, n, k, r, splits, kps, st);
  else launch_gemm<T, false>(trans, in, w, bt, up, scale, out, part, m, n, k, r, splits, kps, st);
  err = last_error();
  if (err != 0 || splits == 1) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + 4 * kMergeThreads - 1) / (4 * kMergeThreads));
  if constexpr (sizeof(T) == 4) {
    if (trans) {
      lora_dx_merge_kernel<<<blocks, kMergeThreads, 0, st>>>(part, out, total, splits);
      return last_error();
    }
  }
  lora_fwd_merge_kernel<T><<<blocks, kMergeThreads, 0, st>>>(part, out, total, splits);
  return last_error();
}

template <int RMAX>
void launch_ab(const float* x, const float* g, const float* xa,
               const float* dy, const float* scale, float* da, float* db,
               int m, int k, int n, int r, cudaStream_t st) {
  const int blocks_a = (k + kCols - 1) / kCols;
  const int blocks_b = (n + kCols - 1) / kCols;
  lora_grad_ab_kernel<RMAX><<<blocks_a + blocks_b, kThreads, 0, st>>>(
      x, g, xa, dy, scale, da, db, m, k, n, r, blocks_a);
}

int ab_rank(const float* x, const float* g, const float* xa, const float* dy,
            const float* scale, float* da, float* db, int m, int k, int n,
            int r, cudaStream_t st) {
  if (r <= 8) launch_ab<8>(x, g, xa, dy, scale, da, db, m, k, n, r, st);
  else if (r <= 16) launch_ab<16>(x, g, xa, dy, scale, da, db, m, k, n, r, st);
  else if (r <= 32) launch_ab<32>(x, g, xa, dy, scale, da, db, m, k, n, r, st);
  else if (r <= 64) launch_ab<64>(x, g, xa, dy, scale, da, db, m, k, n, r, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) = in (M, K) @ W' + s * (in @ D) @ U, with in @ D (M, R,
// float32, unscaled) written to bottleneck first. trans = 0: w (K, N),
// down (K, R), up (R, N) (the forward). trans = 1: w (N, K), down (R, K),
// up (N, R), each read transposed (dx from the forward's W0, B and A),
// float32 only; with base = 0 only the bottleneck (g; out is not written).
// The plan (kernels/lora_matmul.py::plan_splits): n_splits ranges of
// k_per_split (a multiple of the stage depth) along K; with more than one
// split, partials is float32 scratch of n_splits * M * N.
// vec: 16-byte loads and stores (K and N multiples of 16 / element size,
// in, w and out 16-byte aligned); element loads otherwise.
extern "C" int lora_matmul_launch(const void* in, const void* w,
                                  const void* down, const void* up,
                                  const void* scale, void* out,
                                  void* bottleneck, void* partials, int m,
                                  int n, int k, int r, int trans, int base,
                                  int n_splits, int k_per_split, int vec,
                                  int dtype, void* stream) {
  const int esize = dtype == kDtypeF32 ? 4 : 2;
  const int ch = 16 / esize;
  if (r < 1 || r > 64 || m < 0 || n < 0 || k < 0 || bottleneck == nullptr
      || (!base && !trans) || (trans && dtype != kDtypeF32)
      || (dtype != kDtypeF32 && dtype != kDtypeBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  if (base && n > 0) {
    const bool covers = k == 0 ? n_splits == 1
                               : k_per_split > 0 && static_cast<long long>(n_splits) * k_per_split >= k
                                     && static_cast<long long>(n_splits - 1) * k_per_split < k;
    if (n_splits < 1 || n_splits > 65535 || k_per_split % Tile::BK != 0 || !covers
        || (n_splits > 1 && partials == nullptr) || (m + Tile::BM - 1) / Tile::BM > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec && (k % ch != 0 || n % ch != 0 || !host_aligned16(in)
                || !host_aligned16(w) || !host_aligned16(out)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* bt = static_cast<float*>(bottleneck);
  float* part = static_cast<float*>(partials);
  if (dtype == kDtypeF32)
    return run<float>(in, w, down, up, s, out, bt, part, m, n, k, r, trans != 0,
                      base != 0, n_splits, k_per_split, vec != 0, st);
  return run<__nv_bfloat16>(in, w, down, up, s, out, bt, part, m, n, k, r,
                            trans != 0, base != 0, n_splits, k_per_split,
                            vec != 0, st);
}

// dA (K, R) = s * x^T g and dB (R, N) = s * xa^T dy; x (M, K), dy (M, N),
// g and xa (M, R), all float32.
extern "C" int lora_grad_ab_launch(const void* x, const void* g,
                                   const void* xa, const void* dy,
                                   const void* scale, void* da, void* db,
                                   int m, int k, int n, int r, int dtype,
                                   void* stream) {
  if (r < 1 || m < 0 || n < 0 || k < 0 || dtype != kDtypeF32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 && n == 0) return 0;
  return ab_rank(static_cast<const float*>(x), static_cast<const float*>(g),
                 static_cast<const float*>(xa), static_cast<const float*>(dy),
                 static_cast<const float*>(scale), static_cast<float*>(da),
                 static_cast<float*>(db), m, k, n, r,
                 static_cast<cudaStream_t>(stream));
}
