// Shared helpers for the port's hand-written Hopper kernels: element type
// conversion (float32 and bfloat16 storage, float32 arithmetic) and warp
// reductions. Every kernel is exposed through an extern "C" launcher that
// takes raw device pointers and a cudaStream_t, launches on that stream,
// allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element types, as the Python wrappers encode them.
enum { kDtypeF32 = 0, kDtypeBF16 = 1 };

// Masked score sentinel, as the reference kernels use.
constexpr float kNegInf = -1e30f;

// The most dynamic shared memory one block may use on sm_90.
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Asynchronous global -> shared copies (sm_80+). ``src_bytes`` below the
// copy size fills the rest with zeros; 0 reads nothing (the address must
// still be a valid one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes = 4) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``N`` committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Raise a kernel's dynamic shared memory ceiling past the 48 KB default
// when it needs more; the launch is refused otherwise. ``configured`` is the
// caller's record of the ceiling already set for this kernel, so the
// attribute is set once per new maximum and not on every launch (launches
// may be captured into a CUDA graph).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& configured) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024 || bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured = bytes;
  return err;
}
