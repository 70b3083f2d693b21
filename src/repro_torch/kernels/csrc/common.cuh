// Shared helpers for the port's hand-written Hopper kernels: element type
// conversion (float32 and bfloat16 storage, float32 arithmetic), warp
// reductions, asynchronous copies, and the staging, reduce-scatter and
// split-merge pieces of the attention kernels (csrc/flash_attn.cu and the
// paged kernels of csrc/paged_split.cuh). Every kernel is exposed through
// an extern "C" launcher that takes raw device pointers and a
// cudaStream_t, launches on that stream, allocates nothing, and returns
// cudaGetLastError().
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

// Copy rows [0, n) of d elements into shared rows of stride ``dp`` floats;
// row i starts at src(i). With ``vec`` (d a multiple of the 16-byte vector,
// 16-byte aligned bases) float32 rows go by cp.async and bfloat16 rows are
// widened through registers, 16 bytes at a time; otherwise element by
// element. One warp per row, lanes along it.
template <int kWarps, typename T, typename Src>
__device__ __forceinline__ void stage_rows(float* dst, int dp, int n, int d,
                                           bool vec, Src src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    const T* s = src(i);
    float* o = dst + i * dp;
    if (!vec) {
      for (int e = lane; e < d; e += 32) o[e] = to_f32(s[e]);
    } else if constexpr (sizeof(T) == 4) {
      for (int c = lane; c < d / 4; c += 32) cp_async16(o + 4 * c, s + 4 * c);
    } else {
      for (int c = lane; c < d / 8; c += 32) {
        const uint4 raw = *reinterpret_cast<const uint4*>(s + 8 * c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
        *reinterpret_cast<float4*>(o + 8 * c) = make_float4(f0.x, f0.y, f1.x, f1.y);
        *reinterpret_cast<float4*>(o + 8 * c + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
  }
}

// Store 4 consecutive values (``vec``: one vector store) or those below n.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&x)[4], int n,
                                       bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                             __floats2bfloat162_rn(x[2], x[3])};
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n) dst[c] = from_f32<T>(x[c]);
}

// Four consecutive elements as float32 (``vec``: one 16- or 8-byte load),
// zero past n.
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, int n, bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(src);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      return make_float4(f0.x, f0.y, f1.x, f1.y);
    }
  }
  float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n) x[c] = to_f32(src[c]);
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One butterfly step of reduce_scatter32: lanes keep the half of their H
// values that their lane bit H names and add the partner's copy of it.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&x)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? x[i] : x[i + H];
    const float keep = upper ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Each lane holds 32 partial sums; afterwards lane l holds the sum over
// the warp of value l, in a fixed order (31 shuffles).
__device__ __forceinline__ float reduce_scatter32(float (&x)[32], int lane) {
  reduce_scatter_step<16>(x, lane);
  reduce_scatter_step<8>(x, lane);
  reduce_scatter_step<4>(x, lane);
  reduce_scatter_step<2>(x, lane);
  reduce_scatter_step<1>(x, lane);
  return x[0];
}

// The merge of split partials (one (m, l, o) per split and row, laid out as
// the split kernels write them: o (n_splits, total_rows, d), then (m, l)
// pairs): thread t combines row t / ceil(d / 4), 4 head dims, over the
// splits in a fixed order, o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s,
// and rounds to the storage type; its loads of the splits do not depend
// on one another.
template <typename T>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part, T* __restrict__ out, size_t total_rows,
    int d, int n_splits, size_t t) {
  const int chunks = (d + 3) / 4;
  if (t >= total_rows * chunks) return;
  const size_t row = t / chunks;
  const int c0 = static_cast<int>(t - row * chunks) * 4;
  const int n = min(4, d - c0);
  const float* ml = part + static_cast<size_t>(n_splits) * total_rows * d;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, ml[2 * (static_cast<size_t>(s) * total_rows + row)]);
  float den = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_splits; ++s) {
    const size_t prow = static_cast<size_t>(s) * total_rows + row;
    const float w = expf(ml[2 * prow] - mx);
    den += w * ml[2 * prow + 1];
    const float* src = part + prow * d + c0;
    if (d % 4 == 0) {
      const float4 y = *reinterpret_cast<const float4*>(src);
      x[0] += w * y.x;
      x[1] += w * y.y;
      x[2] += w * y.z;
      x[3] += w * y.w;
    } else {
      for (int c = 0; c < n; ++c) x[c] += w * src[c];
    }
  }
  den = fmaxf(den, 1e-30f);  // no split saw a key: every o_s is 0
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] /= den;
  const bool vo = d % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(out) & (4 * sizeof(T) - 1)) == 0;
  store4<T>(out + row * d + c0, x, n, vo);
}
