// Reconstruct-aggregate for HLoRA's server (Eq. 2), batched over items:
//
//     W'[i] = sum_k eta[i, k] * A[i, k] @ B[i, k]        i = 0..Bt-1
//
// A: (Bt, Kc, d_in, R), B: (Bt, Kc, R, d_out), eta: (Bt, Kc), W':
// (Bt, d_in, d_out); float32 storage and arithmetic. One item is one
// (target, layer) of a shape group; the caller folds the rank masks into A
// and B and passes eta = eta_hat_k * alpha / r_eff,k per item and client
// (core/agg_engine.py::_dense_update).
//
// Replaces the TPU kernel src/repro/kernels/recon_agg.py::recon_agg,
// whose grid (d_in/bm, d_out/bn, Kc) walks the client axis innermost and
// accumulates one (bm, bn) float32 tile in VMEM scratch over all clients
// before writing W' once; the reference vmaps it over the items and pads
// R to 128 lanes and d_in, d_out to its blocks. Here a block walks the
// clients itself, the items are walked by persistent blocks, and ragged
// d_in, d_out and R are masked in the kernel: no padding.
//
// Bound on the H100: W'[i] is one float32 product with inner dimension
// Kc*R, 2*Kc*R*d_in*d_out operations against the 4*d_in*d_out bytes of
// the output (the factors are Kc*R*(d_in + d_out) values). At
// RoBERTa-large's server shape (48 items, d 1024, R 8) that is ~201 MB
// written either way, 0.06 ms at 3.35 TB/s, and 0.81 GFLOP per client,
// 0.012 ms at 67 TFLOP/s on CUDA cores: bound by bytes up to Kc 5 (Kc 4:
// ~214 MB, 0.064 ms), by operations above (Kc 20: ~16.1 GFLOP, 0.24 ms).
// At Kc 4 the multiply-adds alone are 0.048 ms at that peak, so the
// kernel reaches its byte bound only if the store stream runs while the
// next tile is computed.
//
// Design: persistent blocks, as many as fit on the card (two per SM: 256
// threads of at most 128 registers, 66 KB of shared memory each), walk the
// 128 x 128 output tiles item-major, so the blocks in flight share a few
// items' factors in L2. A thread keeps an 8 x 8 sub-tile in registers:
// rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, the same for columns, so 4
// 16-byte shared loads feed 64 multiply-adds and each warp's loads fall in
// distinct banks. The inner dimension is the flattened j = k*R + r
// (clients in order, each client's rank directions in order; R is a
// runtime bound, one instantiation), staged 32 deep: at Kc*R <= 32 a tile
// is one stage, deeper cohorts (Kc 20: 160) take several. Each stage has
// two buffers: B's 32 rows of 128 columns go by 16-byte cp.async (4-byte
// where d_out is not a multiple of 4), A's 128 rows x 32 by 4-byte
// cp.async straight into the transposed (j, m) layout, zero past the
// ragged edges; eta_k is folded into A by the thread that copied it once
// its copies have landed. The next stage's copies are issued before this
// stage's products, and there is one block barrier per stage. A
// finished tile leaves with 16-byte streaming stores (st.global.cs), which
// do not stall the thread, so its store stream drains while the next tile
// is loaded and computed. No atomics: the same inputs give the same bits.
// The float32 products run on CUDA cores (no TF32, as the rest of the
// port).
//
// Registers per thread (ptxas, sm_90a, -O3, CUDA 12.8): 128, the cap that
// two blocks an SM leave, with 36 bytes of spill stores and 60 of loads
// (the inner loop unrolled by 8; fully unrolled it spills 8 bytes but ran
// 5% slower at Kc 4). An 8 x 16 sub-tile in 128-thread blocks (227 registers) was
// 3% faster at Kc 20 and 13% slower at Kc 4 (PERF.md).
#include "common.cuh"

namespace {

constexpr int kTile = 128;         // output rows and columns per tile
constexpr int kDepth = 32;         // (client, rank) pairs per stage
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStride = kTile + 4; // shared row stride (floats)
constexpr int kStage = kDepth * kStride;
constexpr size_t kSmemBytes = sizeof(float) * 4 * kStage;  // A, B x 2 stages

struct Tile {
  size_t item;
  int m0, n0;
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_m, int tiles_n) {
  const long long per_item = static_cast<long long>(tiles_m) * tiles_n;
  const long long item = t / per_item;
  const int rem = static_cast<int>(t - item * per_item);
  return {static_cast<size_t>(item), (rem / tiles_n) * kTile,
          (rem % tiles_n) * kTile};
}

__global__ void __launch_bounds__(kThreads, 2)
recon_agg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ eta, float* __restrict__ out,
                 int kc, int d_in, int r, int d_out, int tiles_m, int tiles_n,
                 long long n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;               // 2 x (kDepth, kStride): eta_k A_k[m, r] at (j, m)
  float* s_b = smem + 2 * kStage;  // 2 x (kDepth, kStride): B_k[r, n] at (j, n)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 8 warps as 4 (rows) x 2 (columns), lanes as 4 x 8
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int depth = kc * r;
  const float inv_r = 1.f / r;  // j / r as a float product: exact for j < 2^22
  const int chunks = max(1, (depth + kDepth - 1) / kDepth);  // Kc 0: zeros
  if (blockIdx.x >= n_tiles) return;
  const long long stages = ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * chunks;
  const bool vec_b = d_out % 4 == 0 && aligned16(b);
  const bool vec_out = d_out % 4 == 0 && aligned16(out);

  // A staging: this thread's depths jh*8 + ja (jh 0..3) and rows ma + 32*mm
  // (mm 0..3), copied by 4-byte cp.async into the transposed (j, m) layout;
  // a warp reads 8 consecutive (k, r) of 4 consecutive rows and writes 32
  // distinct banks. eta_k is folded in once the copies have landed, by the
  // thread that issued them.
  const int ja = tid & 7, ma = tid >> 3;
  auto issue = [&](const Tile& tl, int j0, int buf) {
    const float* a_i = a + tl.item * kc * d_in * r;
    float* da = s_a + buf * kStage;
#pragma unroll
    for (int jh = 0; jh < 4; ++jh) {
      const int j = j0 + jh * 8 + ja;
      const int kk = __float2int_rz((j + 0.5f) * inv_r);
      const float* col = a_i + static_cast<size_t>(kk) * d_in * r + (j - kk * r);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int row = tl.m0 + ma + 32 * mm;
        const bool ok = j < depth && row < d_in;
        cp_async4(da + (jh * 8 + ja) * kStride + ma + 32 * mm,
                  ok ? col + static_cast<size_t>(row) * r : a, ok ? 4 : 0);
      }
    }
    const float* b_i = b + tl.item * kc * r * d_out;
    float* db = s_b + buf * kStage;
    if (vec_b) {  // a warp copies 512 contiguous bytes of one row
#pragma unroll
      for (int t = 0; t < kDepth * kTile / 4 / kThreads; ++t) {
        const int e = tid + kThreads * t;
        const int jj = e >> 5, c = (e & 31) * 4;
        const int j = j0 + jj, col = tl.n0 + c;
        const bool ok = j < depth && col < d_out;
        cp_async16(db + jj * kStride + c,
                   ok ? b_i + static_cast<size_t>(j) * d_out + col : b, ok ? 16 : 0);
      }
    } else {
      for (int t = 0; t < kDepth * kTile / kThreads; ++t) {
        const int e = tid + kThreads * t;
        const int jj = e >> 7, c = e & (kTile - 1);
        const int j = j0 + jj, col = tl.n0 + c;
        const bool ok = j < depth && col < d_out;
        cp_async4(db + jj * kStride + c,
                  ok ? b_i + static_cast<size_t>(j) * d_out + col : b, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  auto fold_eta = [&](const Tile& tl, int j0, int buf) {
    const float* eta_i = eta + tl.item * kc;
    float* da = s_a + buf * kStage;
#pragma unroll
    for (int jh = 0; jh < 4; ++jh) {
      const int j = j0 + jh * 8 + ja;
      if (j >= depth) continue;  // zero-filled
      const float e = eta_i[__float2int_rz((j + 0.5f) * inv_r)];
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
        da[(jh * 8 + ja) * kStride + ma + 32 * mm] *= e;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  long long tile = blockIdx.x;
  int chunk = 0;
  Tile tl = tile_at(tile, tiles_m, tiles_n);
  issue(tl, 0, 0);
  for (long long s = 0; s < stages; ++s) {
    const int buf = static_cast<int>(s & 1);
    cp_async_wait<0>();
    fold_eta(tl, chunk * kDepth, buf);
    __syncthreads();  // stage s visible; every thread is done with stage s-1
    const bool last = chunk + 1 == chunks;
    const long long next_tile = last ? tile + gridDim.x : tile;
    const int next_chunk = last ? 0 : chunk + 1;
    const Tile next = last ? tile_at(next_tile, tiles_m, tiles_n) : tl;
    if (s + 1 < stages)  // stage s+1's copies run under stage s's products
      issue(next, next_chunk * kDepth, buf ^ 1);

    const float* sa = s_a + buf * kStage + ty * 4;
    const float* sb = s_b + buf * kStage + tx * 4;
#pragma unroll 8  // faster than fully unrolled (header note)
    for (int jj = 0; jj < kDepth; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + jj * kStride);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + jj * kStride + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + jj * kStride);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + jj * kStride + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }

    if (last) {  // the tile is done: stream it out, start the next from zero
      float* o_i = out + tl.item * d_in * d_out;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = tl.m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
        if (row < d_in) {
          float* dst = o_i + static_cast<size_t>(row) * d_out;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = tl.n0 + tx * 4 + h * 64;
            if (vec_out && col < d_out) {
              __stcs(reinterpret_cast<float4*>(dst + col),
                     make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]));
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (col + c < d_out) __stcs(dst + col + c, acc[i][4 * h + c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
      }
    }
    tile = next_tile;
    chunk = next_chunk;
    tl = next;
  }
}

}  // namespace

extern "C" int recon_agg_launch(const void* a, const void* b, const void* eta,
                                void* out, int batch, int kc, int d_in, int r,
                                int d_out, void* stream) {
  if (batch < 0 || kc < 0 || d_in < 0 || r < 1 || d_out < 0 ||
      static_cast<long long>(kc) * r >= (1 << 22))  // inv_r's exact range
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d_in == 0 || d_out == 0) return 0;
  static size_t configured = 0;
  cudaError_t err = allow_smem(recon_agg_kernel, kSmemBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = 0;  // resident blocks per SM, from the occupancy API
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, recon_agg_kernel,
                                                        kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (d_in + kTile - 1) / kTile;
  const int tiles_n = (d_out + kTile - 1) / kTile;
  const long long n_tiles = static_cast<long long>(batch) * tiles_m * tiles_n;
  const long long grid = n_tiles < static_cast<long long>(sms) * per_sm
                             ? n_tiles : static_cast<long long>(sms) * per_sm;
  recon_agg_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(eta), static_cast<float*>(out), kc, d_in, r,
      d_out, tiles_m, tiles_n, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
