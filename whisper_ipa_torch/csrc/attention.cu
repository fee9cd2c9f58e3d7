// Unmasked attention forward (encoder self-attention) for Hopper (sm_90a).
//
// Replaces: whisper_ipa_tpu/ops/attention.py, fused_attention forward
// (_fused_attention_impl :443, pallas_call :463, body _attn_kernel :39).
//
// out = softmax(scale * q k^T) v over (B*H, T, Dh), Dh in {32, 64}, with
// logits, softmax and the output accumulated in fp32 for bf16 and fp32
// inputs; the scale is folded into q; the output is divided by the row
// sum once at the end.
//
// What bounds it on the H100: on-chip work, not bytes. At the encoder's
// T=1500, Dh=64 a (b, h) pair reads 0.4 MB of q/k/v in bf16 but does
// 4*T^2*Dh = 576 MFLOP; the TPU kernel held one head's whole K/V in VMEM,
// but K+V in bf16 is ~384 KB here, more than a block's 227 KB of shared
// memory, and the (T, T) probabilities must not reach device memory.
//
// Design: flash-style online softmax. A block of 128 threads owns 128
// query rows of one (b, h), one row per thread, the pre-scaled q row and
// the fp32 output row in registers. K/V stream through shared memory in
// 32-key tiles (converted to fp32 on load); each thread takes the tile's
// 32 logits, rescales its running max / sum / accumulator once per tile,
// and adds p*v. Keys past T (the ragged tail: 1500 is no multiple of any
// tile) get -inf logits and zeroed V rows. The products are fp32 FMAs on
// the CUDA cores: simple and exact; a wgmma/mma.sync version is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // query rows (= threads) per block
constexpr int kKeys = 32;   // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int tq,
                     int tk, float scale) {
  __shared__ __align__(16) float ks[kKeys][DH];
  __shared__ __align__(16) float vs[kKeys][DH];

  const size_t bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < tq;
  const T* qb = q + bh * tq * DH;
  const T* kb = k + bh * tk * DH;
  const T* vb = v + bh * tk * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? to_f32(qb[static_cast<size_t>(row) * DH + d]) * scale : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < tk; k0 += kKeys) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kKeys * DH; i += kRows) {
      const int j = i / DH;
      const int d = i - j * DH;
      const int key = k0 + j;
      const bool in = key < tk;
      ks[j][d] = in ? to_f32(kb[static_cast<size_t>(key) * DH + d]) : 0.0f;
      vs[j][d] = in ? to_f32(vb[static_cast<size_t>(key) * DH + d]) : 0.0f;
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[j] = (k0 + j < tk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    // k0 < tk, so every tile has a live key and m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;

#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.0f / l;
    T* o = out + bh * tq * DH + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int tq, int tk, float scale, cudaStream_t stream) {
  const dim3 grid((tq + kRows - 1) / kRows, bh);
  attention_fwd_kernel<T, DH><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, tq, dh); k, v: (bh, tk, dh); out: (bh, tq, dh); all contiguous,
// bf16 when is_bf16 else fp32; dh in {32, 64}; tk >= 1.
// Returns cudaGetLastError().
extern "C" int wipa_attention_fwd(const void* q, const void* k, const void* v,
                                  void* out, int bh, int tq, int tk, int dh,
                                  int is_bf16, float scale, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    err = is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, out, bh, tq, tk, scale, s)
                  : launch<float, 64>(q, k, v, out, bh, tq, tk, scale, s);
  } else if (dh == 32) {
    err = is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, out, bh, tq, tk, scale, s)
                  : launch<float, 32>(q, k, v, out, bh, tq, tk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
