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
// clients itself, the items are a grid axis, and ragged d_in, d_out and R
// are masked in the kernel: no padding.
//
// Bound on the H100: W'[i] is one float32 product with inner dimension
// Kc*R, 2*Kc*R*d_in*d_out operations against the 4*d_in*d_out bytes of
// the output (the factors are Kc*R*(d_in + d_out) values). At
// RoBERTa-large's server shape (48 items, d 1024, R 8) that is ~201 MB
// written either way, 0.06 ms at 3.35 TB/s, and 0.81 GFLOP per client,
// 0.012 ms at 67 TFLOP/s on CUDA cores: bound by bytes up to Kc 5 (Kc 4:
// ~214 MB, 0.064 ms), by operations above (Kc 20: ~16.1 GFLOP, 0.24 ms).
//
// Design: grid (ceil(d_out/64), ceil(d_in/64), Bt), 256 threads. A block
// owns a 64 x 64 output tile of one item; each thread holds a 4 x 4
// sub-tile (4 consecutive rows, 4 consecutive columns) in registers. The
// inner dimension is walked as the flattened index j = k*R + r (clients in
// order, each client's rank directions in order) in chunks of 16: a chunk
// stages eta_k * A_k's 64 rows and B_k's 64 columns for its 16 (k, r)
// pairs in shared memory, zero past the ragged edges, so a chunk may span
// clients when R < 16 and R is a runtime loop bound, not a template
// parameter (one instantiation). The tile is written once with 16-byte
// stores where d_out allows. No atomics: the same inputs give the same
// bits. The float32 products run on CUDA cores (no TF32, as the rest of
// the port); wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kChunk = 16;     // (client, rank) pairs staged at once
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks

__global__ void __launch_bounds__(kThreads)
recon_agg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ eta, float* __restrict__ out,
                 int kc, int d_in, int r, int d_out) {
  __shared__ __align__(16) float s_a[kChunk][kTile + kPad];  // [j][m]
  __shared__ __align__(16) float s_b[kChunk][kTile + kPad];  // [j][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const size_t item = blockIdx.z;
  const float* a_i = a + item * kc * d_in * r;
  const float* b_i = b + item * kc * r * d_out;
  const float* eta_i = eta + item * kc;
  const int depth = kc * r;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < depth; j0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      // A: neighbouring threads on neighbouring (k, r), so a warp reads
      // whole rows of A_k (R contiguous values each)
      const int ja = e % kChunk, m = e / kChunk;
      const int j = j0 + ja, row = m0 + m;
      float va = 0.f;
      if (j < depth && row < d_in) {
        const int k = j / r, rr = j - k * r;
        va = eta_i[k] * a_i[(static_cast<size_t>(k) * d_in + row) * r + rr];
      }
      s_a[ja][m] = va;
      // B: neighbouring threads on neighbouring columns
      const int n = e % kTile, jb = e / kTile;
      const int jj = j0 + jb, col = n0 + n;
      float vb = 0.f;
      if (jj < depth && col < d_out) {
        const int k = jj / r, rr = jj - k * r;
        vb = b_i[(static_cast<size_t>(k) * r + rr) * d_out + col];
      }
      s_b[jb][n] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float4 av = *reinterpret_cast<const float4*>(&s_a[j][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[j][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(am[i], bn[c], acc[i][c]);
    }
    __syncthreads();
  }

  float* out_i = out + item * d_in * d_out;
  const int col = n0 + tx * 4;
  const bool vec = (d_out % 4 == 0) && (col + 3 < d_out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= d_in) break;
    float* dst = out_i + static_cast<size_t>(row) * d_out + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < d_out) dst[c] = acc[i][c];
    }
  }
}

}  // namespace

extern "C" int recon_agg_launch(const void* a, const void* b, const void* eta,
                                void* out, int batch, int kc, int d_in, int r,
                                int d_out, void* stream) {
  if (batch < 0 || kc < 0 || d_in < 0 || r < 1 || d_out < 0 || batch > 65535 ||
      (d_in + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d_in == 0 || d_out == 0) return 0;
  const dim3 grid((d_out + kTile - 1) / kTile, (d_in + kTile - 1) / kTile, batch);
  recon_agg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(eta), static_cast<float*>(out), kc, d_in, r,
      d_out);
  return static_cast<int>(cudaGetLastError());
}
