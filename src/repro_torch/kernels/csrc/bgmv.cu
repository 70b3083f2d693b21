// Batched-gather matrix-vector product (BGMV) for multi-LoRA decode:
//
//     y[i] = x[i] @ A[idx[i]] @ B[idx[i]]        i = 0..B-1
//
// x: (B, d_in), A: (S, d_in, R), B: (S, R, d_out), idx: (B,) int32, y:
// (B, d_out); float32 or bfloat16 storage, float32 accumulation, y in
// x's type. The caller folds the rank mask into A and applies the per-slot
// scale alpha/r_eff afterwards (serve/engine.py::_apply_slab_lora).
//
// Replaces the TPU kernel src/repro/kernels/bgmv.py::bgmv, which steered
// its DMA at A[idx[i]] / B[idx[i]] through scalar-prefetched indices and
// padded R to 128 lanes. Here each block loads its own slot index and
// masks the ragged rank and column edges itself; no padding.
//
// Bound on the H100: bytes. Per row the kernel must read d_in*R + R*d_out
// adapter values and does two multiply-adds per value, far below the
// ~20 flop/byte (float32) or ~295 flop/byte (bfloat16 tensor-core) ridge.
// Design: grid (B, ceil(d_out/256)), 256 threads. Phase one: threads
// stride over d_in, each reading one x value and the R contiguous A values
// of that input row (neighbouring threads on neighbouring rows, so the
// block streams A), keeping R float32 partial sums in registers; a warp
// shuffle plus shared-memory reduction gives xa (R values). Phase two:
// each thread owns one output column and reads B[slot, :, col], coalesced
// across the block. Phase one is repeated by each column block of a row;
// those re-reads of A hit L2. Rows sharing a slot (the engine sorts rows
// by slot) could share A and B reads: later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockN = 256;  // output columns per block

template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ b, const int* __restrict__ idx,
            T* __restrict__ y, int d_in, int r, int d_out, int num_slots) {
  __shared__ float partial[kThreads / 32][RMAX];
  __shared__ float xa[RMAX];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kBlockN + tid;
  const int slot = idx[row];
  if (slot < 0 || slot >= num_slots) {  // uniform across the block
    if (col < d_out) y[static_cast<size_t>(row) * d_out + col] = from_f32<T>(0.f);
    return;
  }

  float acc[RMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k) acc[k] = 0.f;
  const T* xr = x + static_cast<size_t>(row) * d_in;
  const T* as = a + static_cast<size_t>(slot) * d_in * r;
  for (int d = tid; d < d_in; d += kThreads) {
    const float xv = to_f32(xr[d]);
    const T* arow = as + static_cast<size_t>(d) * r;
#pragma unroll
    for (int k = 0; k < RMAX; ++k)
      if (k < r) acc[k] += xv * to_f32(arow[k]);
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < RMAX; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) partial[warp][k] = v;
  }
  __syncthreads();
  if (tid < r) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += partial[w][tid];
    xa[tid] = v;
  }
  __syncthreads();

  if (col < d_out) {
    const T* bs = b + static_cast<size_t>(slot) * r * d_out + col;
    float out = 0.f;
    for (int k = 0; k < r; ++k) out += xa[k] * to_f32(bs[static_cast<size_t>(k) * d_out]);
    y[static_cast<size_t>(row) * d_out + col] = from_f32<T>(out);
  }
}

template <typename T, int RMAX>
void launch(const void* x, const void* a, const void* b, const void* idx,
            void* y, int batch, int d_in, int r, int d_out, int num_slots,
            cudaStream_t stream) {
  const dim3 grid(batch, (d_out + kBlockN - 1) / kBlockN);
  bgmv_kernel<T, RMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const int*>(idx),
      static_cast<T*>(y), d_in, r, d_out, num_slots);
}

template <typename T>
int launch_rank(const void* x, const void* a, const void* b, const void* idx,
                void* y, int batch, int d_in, int r, int d_out, int num_slots,
                cudaStream_t stream) {
  if (r <= 8) launch<T, 8>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, stream);
  else if (r <= 16) launch<T, 16>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, stream);
  else if (r <= 32) launch<T, 32>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, stream);
  else if (r <= 64) launch<T, 64>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bgmv_launch(const void* x, const void* a, const void* b,
                           const void* idx, void* y, int batch, int d_in,
                           int r, int d_out, int num_slots, int dtype,
                           void* stream) {
  if (r < 1 || batch < 0 || d_in < 0 || d_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch_rank<float>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, st);
  if (dtype == kDtypeBF16)
    return launch_rank<__nv_bfloat16>(x, a, b, idx, y, batch, d_in, r, d_out, num_slots, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
