// Fused LoRA matmul, forward and backward, for client training:
//
//     forward   y  = x @ W0 + s * (x @ A) @ B            (xa = x @ A kept)
//     dx        dx = dy @ W0^T + s * (dy @ B^T) @ A^T     (g = dy @ B^T kept)
//     dA, dB    dA = s * x^T g,   dB = s * xa^T dy
//
// x: (M, K), W0: (K, N), A: (K, R), B: (R, N), dy: (M, N); the forward
// takes float32 or bfloat16 storage, the backward float32 only (bf16
// training is not ported); float32 accumulation, outputs in the input
// type; xa and g are float32 (M, R); s is a float32 scalar the kernels
// read from device memory (alpha / r_eff, computed on the device by the
// caller).
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py::lora_matmul,
// whose grid walks K sequentially and accumulates x@W0 and the bottleneck
// x@A in VMEM scratch from the same x block, so x is read once for both
// products; the (R, bn) B tile closes the low-rank path on the last K
// step. It had no backward: the reference trains through plain jnp. Here
// the forward keeps that fusion and the backward is two more kernels. No
// padding: every kernel masks its own ragged M, K, N and rank edges.
//
// Bound on the H100 at the training path's shape (M 512, K = N = 1024,
// R 8, float32): the forward and dx each do 2MKN + 2MR(K + N) ~ 1.09
// GFLOP, 0.016 ms at 67 TFLOP/s on CUDA cores, against ~8.1 MB moved,
// 0.0024 ms at 3.35 TB/s: bound by operations. dA/dB does 2MR(K + N)
// ~ 17 MFLOP over ~4 MB (x, dy, xa, g read once): bound by bytes, 0.0013 ms.
//
// Design.
// lora_mm_tile: a classic shared-memory tiled float32 GEMM on CUDA
// cores. A block owns a 64 x 64 output tile, 256 threads each hold a 4 x 4
// strided sub-tile in registers, and the K loop stages 64 x 16 input and
// 16 x 64 weight tiles. The same staged input tile also feeds the
// bottleneck: the block's 64 x RMAX partial products with a 16 x RMAX
// factor tile, RMAX/8 per thread in registers (ranks are templated 8/16/
// 32/64 as in bgmv.cu). After the K loop the bottleneck goes to shared
// memory and the block adds s * xa @ B[:, tile]; the column-0 block of
// each row tile also writes xa (for the backward). TRANS reads W0, A and B
// transposed in place (no copy), which turns the forward into dx: the
// input is dy, W' = W0^T, the down factor is B^T and the up factor A^T.
// BASE = false skips the W0 product and the output, leaving only the
// bottleneck: it gives g where dx itself is not needed. Each use has its
// own entry, lora_fwd_kernel, lora_dx_kernel and lora_g_kernel, so a
// profile tells them apart by name.
// lora_grad_ab_kernel: the two skinny reductions over M. Each block owns
// 32 columns of x (for dA) or of dy (for dB): a lane per column, eight
// warps splitting the rows, RMAX float32 partial sums per thread, the
// other factor's row broadcast across the warp; the eight partials are
// summed in shared memory in a fixed order (deterministic, no atomics).
#include "common.cuh"

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 16;        // depth of one staged tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // shared-memory row padding (bank spread)

template <typename T, int RMAX, bool TRANS, bool BASE>
__device__ __forceinline__ void
lora_mm_tile(const T* __restrict__ in, const T* __restrict__ w,
             const T* __restrict__ down, const T* __restrict__ up,
             const float* __restrict__ scale, T* __restrict__ out,
             float* __restrict__ bottleneck, int M, int N, int K, int R) {
  // in: (M, K). Not TRANS: w (K, N), down (K, R), up (R, N).
  // TRANS: w (N, K), down stored (R, K), up stored (N, R).
  __shared__ float s_in[kBK][kBM + kPad];   // input tile, [k][m]
  __shared__ float s_w[kBK][kBN + kPad];    // weight tile, [k][n]
  __shared__ float s_down[kBK][RMAX];       // down-factor tile, [k][r]
  __shared__ float s_xa[kBM][RMAX + 1];     // bottleneck rows, [m][r]
  __shared__ float s_up[RMAX][kBN];         // up-factor tile, [r][n]
  constexpr int kXa = kBM * RMAX / kThreads;  // bottleneck sums per thread

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xacc[kXa];
#pragma unroll
  for (int i = 0; i < kXa; ++i) xacc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // input tile: neighbouring threads on neighbouring k of one row
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = e % kBK;
      const int gm = m0 + m, gk = k0 + k;
      s_in[k][m] = (gm < M && gk < K)
                       ? to_f32(in[static_cast<size_t>(gm) * K + gk]) : 0.f;
    }
    if (BASE) {
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        // coalesce along the stored row: n for (K, N), k for (N, K)
        const int k = TRANS ? e % kBK : e / kBN;
        const int n = TRANS ? e / kBK : e % kBN;
        const int gk = k0 + k, gn = n0 + n;
        float v = 0.f;
        if (gk < K && gn < N)
          v = to_f32(TRANS ? w[static_cast<size_t>(gn) * K + gk]
                           : w[static_cast<size_t>(gk) * N + gn]);
        s_w[k][n] = v;
      }
    }
    for (int e = tid; e < kBK * RMAX; e += kThreads) {
      const int k = TRANS ? e % kBK : e / RMAX;
      const int r = TRANS ? e / kBK : e % RMAX;
      const int gk = k0 + k;
      float v = 0.f;
      if (gk < K && r < R)
        v = to_f32(TRANS ? down[static_cast<size_t>(r) * K + gk]
                         : down[static_cast<size_t>(gk) * R + r]);
      s_down[k][r] = v;
    }
    __syncthreads();
    if (BASE) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = s_in[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = s_w[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kXa; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / RMAX, r = e % RMAX;
      float v = xacc[i];
#pragma unroll
      for (int k = 0; k < kBK; ++k) v = fmaf(s_in[k][m], s_down[k][r], v);
      xacc[i] = v;
    }
    __syncthreads();
  }

  // the bottleneck: to shared memory for the epilogue, and to device
  // memory once per row tile (by the first column block)
  const bool write_xa = bottleneck != nullptr && blockIdx.x == 0;
#pragma unroll
  for (int i = 0; i < kXa; ++i) {
    const int e = tid + i * kThreads;
    const int m = e / RMAX, r = e % RMAX;
    s_xa[m][r] = xacc[i];
    if (write_xa && m0 + m < M && r < R)
      bottleneck[static_cast<size_t>(m0 + m) * R + r] = xacc[i];
  }
  if (!BASE) return;  // uniform: a template constant

  for (int e = tid; e < RMAX * kBN; e += kThreads) {
    const int r = TRANS ? e % RMAX : e / kBN;
    const int n = TRANS ? e / RMAX : e % kBN;
    const int gn = n0 + n;
    float v = 0.f;
    if (gn < N && r < R)
      v = to_f32(TRANS ? up[static_cast<size_t>(gn) * R + r]
                       : up[static_cast<size_t>(r) * N + gn]);
    s_up[r][n] = v;
  }
  __syncthreads();
  const float s = *scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m0 + m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n0 + n >= N) continue;
      float lo = 0.f;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) lo = fmaf(s_xa[m][r], s_up[r][n], lo);
      out[static_cast<size_t>(m0 + m) * N + n0 + n] = from_f32<T>(acc[i][j] + s * lo);
    }
  }
}

#define LORA_MM_ARGS(T)                                                     \
  const T* __restrict__ in, const T* __restrict__ w,                        \
      const T* __restrict__ down, const T* __restrict__ up,                 \
      const float* __restrict__ scale, T* __restrict__ out,                 \
      float* __restrict__ bottleneck, int M, int N, int K, int R

// the forward: y and xa
template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads) lora_fwd_kernel(LORA_MM_ARGS(T)) {
  lora_mm_tile<T, RMAX, false, true>(in, w, down, up, scale, out, bottleneck, M, N, K, R);
}

// dx and g (float32: the backward)
template <int RMAX>
__global__ void __launch_bounds__(kThreads) lora_dx_kernel(LORA_MM_ARGS(float)) {
  lora_mm_tile<float, RMAX, true, true>(in, w, down, up, scale, out, bottleneck, M, N, K, R);
}

// g alone, where the input needs no gradient
template <int RMAX>
__global__ void __launch_bounds__(kThreads) lora_g_kernel(LORA_MM_ARGS(float)) {
  lora_mm_tile<float, RMAX, true, false>(in, w, down, up, scale, out, bottleneck, M, N, K, R);
}

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

template <typename T, int RMAX>
void launch_fwd(const T* in, const T* w, const T* down, const T* up,
                const float* scale, T* out, float* xa, int m, int n, int k,
                int r, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  lora_fwd_kernel<T, RMAX><<<grid, kThreads, 0, st>>>(in, w, down, up, scale, out, xa, m, n, k, r);
}

template <typename T>
int fwd_rank(const void* in, const void* w, const void* down, const void* up,
             const float* scale, void* out, float* xa, int m, int n, int k,
             int r, cudaStream_t st) {
  const T* i_ = static_cast<const T*>(in);
  const T* w_ = static_cast<const T*>(w);
  const T* d_ = static_cast<const T*>(down);
  const T* u_ = static_cast<const T*>(up);
  T* o_ = static_cast<T*>(out);
  if (r <= 8) launch_fwd<T, 8>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, st);
  else if (r <= 16) launch_fwd<T, 16>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, st);
  else if (r <= 32) launch_fwd<T, 32>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, st);
  else if (r <= 64) launch_fwd<T, 64>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dx and g (base) or g alone
template <int RMAX>
void launch_bwd(const float* in, const float* w, const float* down,
                const float* up, const float* scale, float* out, float* xa,
                int m, int n, int k, int r, bool base, cudaStream_t st) {
  const dim3 grid(base ? (n + kBN - 1) / kBN : 1, (m + kBM - 1) / kBM);
  if (base)
    lora_dx_kernel<RMAX><<<grid, kThreads, 0, st>>>(in, w, down, up, scale, out, xa, m, n, k, r);
  else
    lora_g_kernel<RMAX><<<grid, kThreads, 0, st>>>(in, w, down, up, scale, out, xa, m, n, k, r);
}

int bwd_rank(const void* in, const void* w, const void* down, const void* up,
             const float* scale, void* out, float* xa, int m, int n, int k,
             int r, bool base, cudaStream_t st) {
  const float* i_ = static_cast<const float*>(in);
  const float* w_ = static_cast<const float*>(w);
  const float* d_ = static_cast<const float*>(down);
  const float* u_ = static_cast<const float*>(up);
  float* o_ = static_cast<float*>(out);
  if (r <= 8) launch_bwd<8>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, base, st);
  else if (r <= 16) launch_bwd<16>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, base, st);
  else if (r <= 32) launch_bwd<32>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, base, st);
  else if (r <= 64) launch_bwd<64>(i_, w_, d_, u_, scale, o_, xa, m, n, k, r, base, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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

// out (M, N) = in (M, K) @ W' + s * (in @ D) @ U, writing in @ D (M, R,
// float32) to xa when it is not null. trans = 0: w (K, N), down (K, R),
// up (R, N) (the forward). trans = 1: w (N, K), down (R, K), up (N, R),
// each read transposed (dx from the forward's W0, B and A), float32 only;
// with base = 0 it computes only xa (g; out is not written).
extern "C" int lora_matmul_launch(const void* in, const void* w,
                                  const void* down, const void* up,
                                  const void* scale, void* out, void* xa,
                                  int m, int n, int k, int r, int trans,
                                  int base, int dtype, void* stream) {
  if (r < 1 || m < 0 || n < 0 || k < 0 || (!base && (xa == nullptr || !trans))
      || (trans && dtype != kDtypeF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || (base && n == 0)) return 0;
  if ((m + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* xa_ = static_cast<float*>(xa);
  // the forward in either type; dx and g (trans) in float32 only
  if (trans)
    return bwd_rank(in, w, down, up, s, out, xa_, m, n, k, r, base != 0, st);
  if (dtype == kDtypeF32)
    return fwd_rank<float>(in, w, down, up, s, out, xa_, m, n, k, r, st);
  if (dtype == kDtypeBF16)
    return fwd_rank<__nv_bfloat16>(in, w, down, up, s, out, xa_, m, n, k, r, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
