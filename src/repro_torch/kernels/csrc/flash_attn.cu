// Flash attention with a causal mask at a run-time absolute offset and an
// optional sliding window (chunked prefill).
//
// q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with Hkv dividing H (query head
// h reads KV head h / (H / Hkv)); out: (B, Sq, H, D). Query i of batch row
// b sits at absolute position q_offset[b] + i and key j at position j;
// key j is visible when j <= qpos (causal) and j > qpos - window (window).
// A query whose keys are all masked writes zeros. q_offset is either a
// (B,) int32 device array or one scalar passed by value, so a new offset
// never needs a new build. float32 or bfloat16 storage, float32 online
// softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention,
// which ran the KV axis as a sequential grid dimension with the offset in
// scalar-prefetch memory, needed block sizes that divide Sq and Skv, took
// repeated KV heads, and was vmapped over the batch. Here each block loops
// over KV tiles itself, masks ragged edges, reads the shared KV head
// directly, and takes the batch as a grid dimension.
//
// Bound on the H100: operations. One prefill chunk of Gemma-2B (64 queries,
// 8 heads, D = 256, a few hundred keys) does ~4 * D multiply-adds per
// visible (query, key) pair against 2 * D values read per key, and all 8
// query heads share one KV head. Design: grid (B * H, ceil(Sq / 16)), 256
// threads; a 16-query tile of Q and a float32 output accumulator stay in
// shared memory while 32-key tiles of K (rows padded by one float, so a
// warp's 32 keys hit 32 banks) and V stream through it, stopping at the
// tile's causal frontier and starting at its window edge; tiles past the
// frontier would be fully masked, so skipping them changes nothing. The
// products run on the CUDA cores in float32 (no tensor cores yet): this
// first version is meant to be right, not fast.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 16;
constexpr int kBlockK = 32;  // one key per lane in the softmax update

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_offsets,
                  int q_offset_scalar, T* __restrict__ out, int sq, int skv,
                  int heads, int kv_heads, int d, int causal, int window,
                  float scale) {
  extern __shared__ float smem[];
  const int ks = d + 1;                   // padded K row stride
  float* q_s = smem;                      // (BQ, d)
  float* o_s = q_s + kBlockQ * d;         // (BQ, d)
  float* k_s = o_s + kBlockQ * d;         // (BK, d + 1)
  float* v_s = k_s + kBlockK * ks;        // (BK, d)
  float* s_s = v_s + kBlockK * d;         // (BQ, BK)
  float* m_s = s_s + kBlockQ * kBlockK;   // (BQ,)
  float* l_s = m_s + kBlockQ;             // (BQ,)
  float* alpha_s = l_s + kBlockQ;         // (BQ,)

  const int bi = blockIdx.x / heads, hi = blockIdx.x % heads;
  const int kh = hi / (heads / kv_heads);
  const int q0 = blockIdx.y * kBlockQ;
  const int nq = min(kBlockQ, sq - q0);
  const int qoff = q_offsets != nullptr ? q_offsets[bi] : q_offset_scalar;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;

  for (int e = tid; e < kBlockQ * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    q_s[e] = i < nq ? to_f32(q[((static_cast<size_t>(bi) * sq + q0 + i) * heads + hi) * d + dd])
                    : 0.f;
    o_s[e] = 0.f;
  }
  for (int i = tid; i < kBlockQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // Keys any query of this tile can see: [kbeg, kend).
  const int qlo = qoff + q0, qhi = qoff + q0 + nq - 1;
  const int kend = causal ? min(skv, qhi + 1) : skv;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  for (int k0 = (kbeg / kBlockK) * kBlockK; k0 < kend; k0 += kBlockK) {
    const int nk = min(kBlockK, skv - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockK * d; e += kThreads) {
      const int j = e / d, dd = e % d;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = ((static_cast<size_t>(bi) * skv + k0 + j) * kv_heads + kh) * d + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[j * ks + dd] = kv;
      v_s[e] = vv;
    }
    __syncthreads();

    for (int e = tid; e < kBlockQ * kBlockK; e += kThreads) {
      const int i = e / kBlockK, j = e % kBlockK;
      const int qpos = qoff + q0 + i, kpos = k0 + j;
      const bool visible = i < nq && j < nk && (!causal || kpos <= qpos) &&
                           (window <= 0 || kpos > qpos - window);
      float s = kNegInf;
      if (visible) {
        const float* qr = q_s + i * d;
        const float* kr = k_s + j * ks;
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd) dot += qr[dd] * kr[dd];
        s = dot * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();

    for (int i = warp; i < kBlockQ; i += nwarps) {
      const float s = s_s[i * kBlockK + lane];
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s == kNegInf ? 0.f : expf(s - m_new);
      s_s[i * kBlockK + lane] = p;
      const float sum = warp_sum(p);  // also orders every lane's read of m_s[i]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < kBlockQ * d; e += kThreads) {
      const int i = e / d, dd = e % d;
      const float* pr = s_s + i * kBlockK;
      float acc = o_s[e] * alpha_s[i];
      for (int j = 0; j < nk; ++j) acc += pr[j] * v_s[j * d + dd];
      o_s[e] = acc;
    }
  }
  __syncthreads();

  for (int e = tid; e < nq * d; e += kThreads) {
    const int i = e / d, dd = e % d;
    const float o = o_s[e] / fmaxf(l_s[i], 1e-30f);  // l == 0: no visible key, o_s == 0
    out[((static_cast<size_t>(bi) * sq + q0 + i) * heads + hi) * d + dd] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_offsets,
           int q_offset_scalar, void* out, int batch, int sq, int skv,
           int heads, int kv_heads, int d, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(kBlockQ) * d + static_cast<size_t>(kBlockK) * (d + 1) +
       static_cast<size_t>(kBlockK) * d + kBlockQ * kBlockK + 3 * kBlockQ);
  static size_t configured = 0;  // one per kernel and type
  cudaError_t err = allow_smem(flash_attn_kernel<T>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (sq + kBlockQ - 1) / kBlockQ);
  flash_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offsets),
      q_offset_scalar, static_cast<T*>(out), sq, skv, heads, kv_heads, d,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const void* q_offsets, int q_offset_scalar,
                                 void* out, int batch, int sq, int skv,
                                 int heads, int kv_heads, int d, int causal,
                                 int window, float scale, int dtype,
                                 void* stream) {
  if (batch < 0 || sq < 0 || skv < 0 || d < 1 || kv_heads < 1 ||
      heads < kv_heads || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return launch<float>(q, k, v, q_offsets, q_offset_scalar, out, batch, sq,
                         skv, heads, kv_heads, d, causal, window, scale, st);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, k, v, q_offsets, q_offset_scalar, out,
                                 batch, sq, skv, heads, kv_heads, d, causal,
                                 window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
