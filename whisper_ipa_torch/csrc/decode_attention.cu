// Single-query cross-attention over the int8 (K4) and the nibble-packed int4
// (K8) T-minor caches, for Hopper (sm_90a).
//
// K4 replaces: whisper_ipa_tpu/ops/decode_attention.py,
// decode_cross_attention_int8_tminor (:83, pallas_call :112, body _kernel
// :46). K8 replaces: decode_cross_attention_int4_tminor (:188, pallas_call
// :236, body _kernel_int4 :122).
//
// For each (b, h), with q pre-scaled by Dh^-0.5, codes (Dh, T_pad) int8 and
// scales (T_pad,) f32 where scale 0 marks a padded position:
//   logit_t = (q . k_codes[:, t]) * k_scale_t   (-inf where k_scale_t == 0)
//   out     = sum_t exp(logit_t - max) * v_scale_t * v_codes[:, t]
//             / sum_t exp(logit_t - max)
//
// What bounds it on the H100: device-memory bytes. Each decode step of each
// decoder layer reads the whole int8 cache once (2 * B * H * Dh * T_pad
// bytes plus f32 scales, ~37 MB a layer for whisper-small at batch 16) and
// does ~2 FLOPs per byte, far below the ridge. Without this kernel eager
// PyTorch would first write a bf16 copy of the cache, tripling the bytes.
//
// Design: the codes are dequantised in registers and never written back.
// One query per (b, h) gives only B*H blocks (96 at batch 8 for 132 SMs),
// so T is split across blocks (flash-decoding): pass 1 gives each
// (split, b*h) block a 128-multiple slice of T; its threads read the K
// codes four positions at a time (char4, coalesced along T), keep the
// slice's logits in shared memory, and reduce max and sum; the V scales
// fold into the probabilities; each warp then takes Dh rows of the V codes
// and reduces p . v_codes over the slice. Pass 2 merges the slices' (max,
// sum, acc) with the usual rescaling and divides by the row sum once.
//
// K8 is the same two passes over half the bytes: byte t2 of a (b, h, d)
// row holds position 2*t2 in its low nibble and 2*t2+1 in its high, each a
// sign-extended 4-bit code, and the scales keep the natural (B, H, T_pad)
// order. A thread widens one char4 (eight positions) at a time in
// registers, so the logits land in shared memory in position order: the
// max and the row sum are taken over both nibble planes together, and the
// output is the two planes' AV dots summed, divided once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Reduce over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// grid (n_split, bh); dynamic shared memory: chunk floats.
// part: (bh, n_split, DH + 2) f32 = [acc(DH), max, sum].
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                      const float* __restrict__ ks,
                      const int8_t* __restrict__ vc,
                      const float* __restrict__ vs, float* __restrict__ part,
                      int t_pad, int chunk) {
  extern __shared__ __align__(16) float p[];
  __shared__ float qs[DH];
  __shared__ float scratch[kWarps];

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const size_t bh = blockIdx.y;
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, t_pad);
  const int n4 = (t1 - t0) / 4;  // t0, t1 and t_pad are multiples of 4
  const int row4 = t_pad / 4;    // char4 / float4 per (b, h, d) row

  if (threadIdx.x < DH) qs[threadIdx.x] = to_f32(q[bh * DH + threadIdx.x]);
  __syncthreads();

  const char4* k4 = reinterpret_cast<const char4*>(kc + bh * DH * t_pad) + t0 / 4;
  const float4* ks4 = reinterpret_cast<const float4*>(ks + bh * t_pad) + t0 / 4;
  float local_max = -INFINITY;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const char4 c = k4[static_cast<size_t>(d) * row4 + i];
      const float qd = qs[d];
      a0 = fmaf(qd, static_cast<float>(c.x), a0);
      a1 = fmaf(qd, static_cast<float>(c.y), a1);
      a2 = fmaf(qd, static_cast<float>(c.z), a2);
      a3 = fmaf(qd, static_cast<float>(c.w), a3);
    }
    const float4 sc = ks4[i];
    const float l0 = sc.x > 0.f ? a0 * sc.x : -INFINITY;
    const float l1 = sc.y > 0.f ? a1 * sc.y : -INFINITY;
    const float l2 = sc.z > 0.f ? a2 * sc.z : -INFINITY;
    const float l3 = sc.w > 0.f ? a3 * sc.w : -INFINITY;
    reinterpret_cast<float4*>(p)[i] = make_float4(l0, l1, l2, l3);
    local_max = fmaxf(local_max, fmaxf(fmaxf(l0, l1), fmaxf(l2, l3)));
  }
  const float m = block_reduce<true>(local_max, scratch);

  const float* vsb = vs + bh * t_pad + t0;
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < t1 - t0; t += kThreads) {
    const float lg = p[t];
    const float e = lg == -INFINITY ? 0.f : expf(lg - m);
    local_sum += e;
    p[t] = e * vsb[t];  // fold the V scale into the probability
  }
  const float l = block_reduce<false>(local_sum, scratch);  // syncs p too

  const char4* v4 = reinterpret_cast<const char4*>(vc + bh * DH * t_pad) + t0 / 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* out = part + (bh * n_split + split) * (DH + 2);
  for (int d = warp; d < DH; d += kWarps) {
    float acc = 0.f;
    for (int i = lane; i < n4; i += 32) {
      const char4 c = v4[static_cast<size_t>(d) * row4 + i];
      const float4 pp = reinterpret_cast<const float4*>(p)[i];
      acc = fmaf(pp.x, static_cast<float>(c.x), acc);
      acc = fmaf(pp.y, static_cast<float>(c.y), acc);
      acc = fmaf(pp.z, static_cast<float>(c.z), acc);
      acc = fmaf(pp.w, static_cast<float>(c.w), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[d] = acc;
  }
  if (threadIdx.x == 0) {
    out[DH] = m;
    out[DH + 1] = l;
  }
}

__device__ __forceinline__ float nib_lo(int8_t b) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(static_cast<int>(b)) << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(int8_t b) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(static_cast<int>(b)) << 24) >> 28);
}

// K8 pass 1. grid (n_split, bh); dynamic shared memory: chunk floats.
// kp/vp: (bh, DH, t_pad / 2) packed; ks/vs: (bh, t_pad) f32.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_partial_int4_kernel(const T* __restrict__ q,
                           const int8_t* __restrict__ kp,
                           const float* __restrict__ ks,
                           const int8_t* __restrict__ vp,
                           const float* __restrict__ vs,
                           float* __restrict__ part, int t_pad, int chunk) {
  extern __shared__ __align__(16) float p[];
  __shared__ float qs[DH];
  __shared__ float scratch[kWarps];

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const size_t bh = blockIdx.y;
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, t_pad);
  const int n8 = (t1 - t0) / 8;  // char4 words, eight positions each
  const int row4 = t_pad / 8;    // char4 words per (b, h, d) row

  if (threadIdx.x < DH) qs[threadIdx.x] = to_f32(q[bh * DH + threadIdx.x]);
  __syncthreads();

  const char4* k4 = reinterpret_cast<const char4*>(kp + bh * DH * (t_pad / 2)) + t0 / 8;
  const float4* ks4 = reinterpret_cast<const float4*>(ks + bh * t_pad) + t0 / 4;
  float local_max = -INFINITY;
  for (int i = threadIdx.x; i < n8; i += kThreads) {
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const char4 c = k4[static_cast<size_t>(d) * row4 + i];
      const float qd = qs[d];
      a[0] = fmaf(qd, nib_lo(c.x), a[0]);
      a[1] = fmaf(qd, nib_hi(c.x), a[1]);
      a[2] = fmaf(qd, nib_lo(c.y), a[2]);
      a[3] = fmaf(qd, nib_hi(c.y), a[3]);
      a[4] = fmaf(qd, nib_lo(c.z), a[4]);
      a[5] = fmaf(qd, nib_hi(c.z), a[5]);
      a[6] = fmaf(qd, nib_lo(c.w), a[6]);
      a[7] = fmaf(qd, nib_hi(c.w), a[7]);
    }
    const float4 s0 = ks4[2 * i];
    const float4 s1 = ks4[2 * i + 1];
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      l[e] = sc[e] > 0.f ? a[e] * sc[e] : -INFINITY;
      local_max = fmaxf(local_max, l[e]);
    }
    reinterpret_cast<float4*>(p)[2 * i] = make_float4(l[0], l[1], l[2], l[3]);
    reinterpret_cast<float4*>(p)[2 * i + 1] = make_float4(l[4], l[5], l[6], l[7]);
  }
  const float m = block_reduce<true>(local_max, scratch);

  const float* vsb = vs + bh * t_pad + t0;
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < t1 - t0; t += kThreads) {
    const float lg = p[t];
    const float e = lg == -INFINITY ? 0.f : expf(lg - m);
    local_sum += e;
    p[t] = e * vsb[t];  // fold the V scale into the probability
  }
  const float l = block_reduce<false>(local_sum, scratch);  // syncs p too

  const char4* v4 = reinterpret_cast<const char4*>(vp + bh * DH * (t_pad / 2)) + t0 / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* out = part + (bh * n_split + split) * (DH + 2);
  for (int d = warp; d < DH; d += kWarps) {
    float acc = 0.f;
    for (int i = lane; i < n8; i += 32) {
      const char4 c = v4[static_cast<size_t>(d) * row4 + i];
      const float4 p0 = reinterpret_cast<const float4*>(p)[2 * i];
      const float4 p1 = reinterpret_cast<const float4*>(p)[2 * i + 1];
      acc = fmaf(p0.x, nib_lo(c.x), acc);
      acc = fmaf(p0.y, nib_hi(c.x), acc);
      acc = fmaf(p0.z, nib_lo(c.y), acc);
      acc = fmaf(p0.w, nib_hi(c.y), acc);
      acc = fmaf(p1.x, nib_lo(c.z), acc);
      acc = fmaf(p1.y, nib_hi(c.z), acc);
      acc = fmaf(p1.z, nib_lo(c.w), acc);
      acc = fmaf(p1.w, nib_hi(c.w), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[d] = acc;
  }
  if (threadIdx.x == 0) {
    out[DH] = m;
    out[DH + 1] = l;
  }
}

// grid (bh,), DH threads: merge the splits and divide by the row sum.
template <typename T, int DH>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pb = part + bh * n_split * (DH + 2);
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pb[s * (DH + 2) + DH]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = pb[s * (DH + 2) + DH];
    const float w = ms == -INFINITY ? 0.f : expf(ms - m);
    num = fmaf(w, pb[s * (DH + 2) + d], num);
    den = fmaf(w, pb[s * (DH + 2) + DH + 1], den);
  }
  out[bh * DH + d] = from_f32<T>(num / den);  // all keys masked: 0/0 = NaN
}

template <typename T, int DH, bool kInt4>
cudaError_t launch(const void* q, const void* kc, const void* ks,
                   const void* vc, const void* vs, void* out, void* part,
                   int bh, int t_pad, int n_split, int chunk,
                   cudaStream_t stream) {
  const dim3 grid(n_split, bh);
  auto partial = kInt4 ? decode_partial_int4_kernel<T, DH>
                       : decode_partial_kernel<T, DH>;
  partial<<<grid, kThreads, chunk * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<float*>(part), t_pad, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, DH><<<bh, DH, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n_split);
  return cudaGetLastError();
}

template <bool kInt4>
int dispatch(const void* q, const void* k_codes, const void* k_scale,
             const void* v_codes, const void* v_scale, void* out, void* part,
             int bh, int dh, int t_pad, int n_split, int chunk, int is_bf16,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t_pad % 128 || chunk % 128 || chunk <= 0 ||
      static_cast<long>(n_split) * chunk < t_pad ||
      chunk * sizeof(float) > 32 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WIPA_DECODE(T, DH)                                                   \
  launch<T, DH, kInt4>(q, k_codes, k_scale, v_codes, v_scale, out, part, bh, \
                       t_pad, n_split, chunk, s)
  if (dh == 64) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 64) : WIPA_DECODE(float, 64);
  } else if (dh == 32) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 32) : WIPA_DECODE(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIPA_DECODE
  return static_cast<int>(err);
}

}  // namespace

// K4. q: (bh, dh) bf16 or f32 (is_bf16), already scaled by dh^-0.5;
// k_codes, v_codes: (bh, dh, t_pad) int8; k_scale, v_scale: (bh, t_pad) f32.
// K8 (wipa_decode_attention_int4): the same but k_codes, v_codes are (bh,
// dh, t_pad / 2) nibble-packed. out: (bh, dh) in q's type; part: (bh,
// n_split, dh + 2) f32 scratch. t_pad % 128 == 0, chunk % 128 == 0, n_split
// * chunk >= t_pad, chunk * 4 bytes <= 32 KB; dh in {32, 64}. Return
// cudaGetLastError().
extern "C" int wipa_decode_attention_int8(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, void* part, int bh,
    int dh, int t_pad, int n_split, int chunk, int is_bf16, int device,
    void* stream) {
  return dispatch<false>(q, k_codes, k_scale, v_codes, v_scale, out, part, bh,
                         dh, t_pad, n_split, chunk, is_bf16, device, stream);
}

extern "C" int wipa_decode_attention_int4(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, void* part, int bh,
    int dh, int t_pad, int n_split, int chunk, int is_bf16, int device,
    void* stream) {
  return dispatch<true>(q, k_codes, k_scale, v_codes, v_scale, out, part, bh,
                        dh, t_pad, n_split, chunk, is_bf16, device, stream);
}
