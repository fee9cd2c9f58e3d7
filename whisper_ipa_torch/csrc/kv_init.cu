// Fused cross-attention K/V cache build for Hopper (sm_90a): projection and
// int8 quantization in one kernel, written in the T-minor decode layout.
//
// Replaces: whisper_ipa_tpu/ops/kv_init.py, fused_kv_init_int8 (:79,
// pallas_call :135, body _kernel :34).
//
// For one layer, with x (B, T, d_in) and W (d_in, d) in the compute type
// (f32 or bf16) and a bias pre-rounded to that type (zeros for K):
//   y   = round_to_type(round_to_type(x @ W, accumulated in f32) + b)
//   per (b, position t, head h), over the head's Dh outputs:
//   s   = max(max |y|, 1e-8) / 127
//   codes[b, h, :, t] = round_half_even(y / s)   (int8),  scale[b, h, t] = s
// with code 0 and scale 0 for T <= t < T_pad (scale 0 is the decode mask).
// This is the rounding order of linear() followed by _quantize_kv_heads.
//
// What bounds it on the H100: the products, 2 * B * T * d_in * d per
// tensor (28 GFLOP each for whisper-small at batch 16), over the tensor
// cores' bf16 rate, ~57 us a layer for the pair; the bytes (x once, two
// (d_in, d) weights, int8 codes) are ~45 MB, ~13 us. What the fusion saves
// is the unfused path's (B, T, d) projection written and read back and
// its transpose. Design (simple first): one block computes a 64-position
// x Dh tile, that is whole heads, so each (position, head) maximum is
// taken inside the block with shuffles over the 16 lanes that share a row;
// the product is a classic shared-memory tile loop (32-deep K steps, 4 x
// Dh/16 outputs a thread, f32 FMAs on the CUDA cores); codes are staged in
// shared memory and leave as 64 contiguous bytes a (head dim, tile) row,
// T already minor. The grid runs the 2 * H tiles that share one x tile
// next to each other, so x is read from device memory about once. A
// tensor-core (mma.sync / wgmma) product is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;  // positions a block
constexpr int kBK = 32;  // input features a K step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Round an f32 value to the compute type and back.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// grid (2 * H, T_pad / kBT, B): blockIdx.x = tensor * H + head, tensor 0 = K.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
kv_init_kernel(const T* __restrict__ x, const T* __restrict__ wk,
               const float* __restrict__ bk, const T* __restrict__ wv,
               const float* __restrict__ bv, int8_t* __restrict__ kc,
               float* __restrict__ ks, int8_t* __restrict__ vc,
               float* __restrict__ vs, int t_len, int t_pad, int d_in,
               int n_head) {
  constexpr int kCols = DH / 16;  // output columns a thread
  __shared__ float xs[kBK][kBT + 1];
  __shared__ float wt[kBK][DH];
  __shared__ int8_t codes[DH][kBT + 4];

  const int tensor = blockIdx.x / n_head;
  const int head = blockIdx.x % n_head;
  const int t0 = blockIdx.y * kBT;
  const size_t b = blockIdx.z;
  const int d = n_head * DH;
  const T* w = tensor ? wv : wk;
  const float* bias = tensor ? bv : bk;
  int8_t* code_out = tensor ? vc : kc;
  float* scale_out = tensor ? vs : ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group; the 16 lanes of a half-warp
  const int ty = tid >> 4;  // row group
  const T* xb = x + b * t_len * d_in;

  float acc[4][kCols] = {};
  for (int k0 = 0; k0 < d_in; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;  // coalesced along the features
      const int t = t0 + r;
      xs[c][r] = t < t_len ? to_f32(xb[static_cast<size_t>(t) * d_in + k0 + c]) : 0.f;
    }
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      wt[r][c] = to_f32(w[static_cast<size_t>(k0 + r) * d + head * DH + c]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bw[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bw[j] = wt[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: linear()'s rounding, then the per-(position, head) quantizer
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool valid = t0 + r < t_len;
    float y[kCols];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float bj = bias[head * DH + tx + 16 * j];
      y[j] = round_to<T>(round_to<T>(acc[i][j]) + bj);
      amax = fmaxf(amax, fabsf(y[j]));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      codes[tx + 16 * j][r] =
          valid ? static_cast<int8_t>(static_cast<int>(rintf(y[j] / s))) : 0;
    }
    if (tx == 0) {
      scale_out[(b * n_head + head) * t_pad + t0 + r] = valid ? s : 0.f;
    }
  }
  __syncthreads();
  // codes: DH rows of kBT contiguous bytes at [b, head, row, t0 : t0 + kBT]
  int8_t* dst = code_out + (b * n_head + head) * static_cast<size_t>(DH) * t_pad + t0;
  for (int i = tid; i < DH * (kBT / 4); i += kThreads) {
    const int row = i / (kBT / 4), w4 = i % (kBT / 4);
    const int8_t* src = &codes[row][4 * w4];
    reinterpret_cast<char4*>(dst + static_cast<size_t>(row) * t_pad)[w4] =
        make_char4(src[0], src[1], src[2], src[3]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* x, const void* wk, const void* bk,
                   const void* wv, const void* bv, void* kc, void* ks,
                   void* vc, void* vs, int batch, int t_len, int t_pad,
                   int d_in, int n_head, cudaStream_t stream) {
  const dim3 grid(2 * n_head, t_pad / kBT, batch);
  kv_init_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk),
      static_cast<const float*>(bk), static_cast<const T*>(wv),
      static_cast<const float*>(bv), static_cast<int8_t*>(kc),
      static_cast<float*>(ks), static_cast<int8_t*>(vc),
      static_cast<float*>(vs), t_len, t_pad, d_in, n_head);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, t_len, d_in) f32 or bf16 (is_bf16); wk, wv: (d_in, n_head *
// dh) in x's type; bk, bv: (n_head * dh,) f32, already rounded to x's type;
// k_codes, v_codes: (batch, n_head, dh, t_pad) int8; k_scale, v_scale:
// (batch, n_head, t_pad) f32. t_pad % 128 == 0, t_pad >= t_len, d_in % 32
// == 0, dh in {32, 64}. Returns cudaGetLastError().
extern "C" int wipa_kv_init_int8(const void* x, const void* wk, const void* bk,
                                 const void* wv, const void* bv,
                                 void* k_codes, void* k_scale, void* v_codes,
                                 void* v_scale, int batch, int t_len,
                                 int t_pad, int d_in, int n_head, int dh,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || t_len <= 0 || t_pad % 128 || t_pad < t_len ||
      d_in % kBK || n_head <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WIPA_KV_INIT(T, DH)                                                   \
  launch<T, DH>(x, wk, bk, wv, bv, k_codes, k_scale, v_codes, v_scale, batch, \
                t_len, t_pad, d_in, n_head, s)
  if (dh == 64) {
    err = is_bf16 ? WIPA_KV_INIT(__nv_bfloat16, 64) : WIPA_KV_INIT(float, 64);
  } else if (dh == 32) {
    err = is_bf16 ? WIPA_KV_INIT(__nv_bfloat16, 32) : WIPA_KV_INIT(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIPA_KV_INIT
  return static_cast<int>(err);
}
