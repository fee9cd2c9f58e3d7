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
// (d_in, d) weights, int8 codes) are ~77 MB, ~23 us. What the fusion saves
// is the unfused path's (B, T, d) projection written and read back and
// its transpose.
//
// bf16 design (wgmma, one warpgroup a block): a block owns 64 positions of
// one (batch, head) and computes K and V of that head, two 64 x Dh f32
// accumulators, so each x tile is read once for both; grid (H, T_pad / 64,
// B), heads fastest, so the H blocks that share an x tile run side by side
// and x comes from device memory about once. d_in streams in 64-feature
// k-tiles through a two-stage ring (16-byte cp.async a thread, the next
// tile in flight while this one is multiplied): the x tile (64 positions x
// 64 features, K-major, 128-byte swizzle) is A, and the Wk and Wv tiles
// (64 features x Dh, Dh contiguous) are MN-major B operands read with the
// transpose bit, as V is in K2 (attention.cu); the swizzles and loads are
// attention_tiles.cuh's. Positions past T are zero-filled by the copy.
// Each k-tile's four k-steps go into a fresh partial accumulator, which is
// then added to the running f32 sum on the CUDA cores: one accumulator
// carried through all 48 k-steps left three times as many codes off the
// plain version's (bf16 roundings of the projection falling the other
// way), and with the bias a code two steps off at an equal scale (PERF.md
// section 6).
// Epilogue in registers: wgmma's accumulator gives each quad of lanes one
// position's Dh columns, so linear()'s two roundings and the bias apply in
// place, the (position, head) maximum takes two shuffles, and the codes
// are staged transposed in shared memory and leave as 64 contiguous bytes
// a (head dim, tile) row, T already minor.
//
// f32 keeps the CUDA-core body (TF32 would miss the f32 bound): one block
// computes a 64-position x Dh tile of K or V, whole heads, in a classic
// shared-memory tile loop (32-deep K steps, 4 x Dh/16 outputs a thread,
// f32 FMAs), the maximum over the 16 lanes that share a row; grid (2 * H,
// T_pad / 64, B), the 2 * H tiles of one x tile side by side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wipa::Tile;

constexpr int kBT = 64;  // positions a block

// -- bf16: wgmma ------------------------------------------------------------

constexpr int kWgThreads = 128;         // one warpgroup
constexpr int kBKF = 64;                // input features a k-tile
constexpr int kCodeStride = kBT + 16;   // bytes a staged code row

template <int DH>
__host__ __device__ constexpr int wg_stage_bytes() {  // the x tile, then the Wk and Wv tiles
  return Tile<64>::kBytes + 2 * Tile<DH>::kBytes;
}

template <int DH>
__host__ __device__ constexpr int wg_smem_bytes() {
  return 2 * wg_stage_bytes<DH>() + 1024;  // two stages; 1024-byte alignment
}

template <int DH>
__device__ __forceinline__ void wgmma_xw(float (&d)[DH / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (DH == 64) {
    wipa::wgmma_m64n64k16_ss<1>(d, da, db, scale_d);
  } else {
    wipa::wgmma_m64n32k16_ss<1>(d, da, db, scale_d);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One tensor's epilogue: acc holds rows 16 w + l / 4 ("lo") and that + 8
// ("hi") of the 64-position tile, register 4 j + 2 i + c being row lo
// (i = 0) or hi (i = 1), column 8 j + 2 (l % 4) + c. Codes go to the
// staging rows codes[column][position], scales straight to device memory.
template <int DH>
__device__ __forceinline__ void quantize_tile(const float (&acc)[DH / 2],
                                              const float* __restrict__ bias,
                                              uint8_t* codes,
                                              float* __restrict__ scale,
                                              int t0, int t_len, int warp,
                                              int lane) {
  const int col = 2 * (lane & 3);
  float y[DH / 2];
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int reg = 4 * j + r;
      y[reg] = round_bf16(round_bf16(acc[reg]) + bias[8 * j + col + (r & 1)]);
      amax[r >> 1] = fmaxf(amax[r >> 1], fabsf(y[reg]));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
    const int row = 16 * warp + (lane >> 2) + 8 * i;
    const bool valid = t0 + row < t_len;
    const float s = fmaxf(amax[i], 1e-8f) / 127.0f;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = static_cast<int>(rintf(y[4 * j + 2 * i + c] / s));
        codes[(8 * j + col + c) * kCodeStride + row] =
            valid ? static_cast<uint8_t>(q) : 0;
      }
    }
    if ((lane & 3) == 0) scale[t0 + row] = valid ? s : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads)
kv_init_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ wk,
              const float* __restrict__ bk, const bf16* __restrict__ wv,
              const float* __restrict__ bv, int8_t* __restrict__ kc,
              float* __restrict__ ks, int8_t* __restrict__ vc,
              float* __restrict__ vs, int t_len, int t_pad, int d_in,
              int n_head) {
  constexpr int XB = Tile<64>::kBytes;
  constexpr int WB = Tile<DH>::kBytes;
  constexpr int SB = wg_stage_bytes<DH>();
  constexpr int RB = Tile<DH>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = blockIdx.x;
  const int t0 = blockIdx.y * kBT;
  const size_t b = blockIdx.z;
  const size_t d = static_cast<size_t>(n_head) * DH;
  const bf16* xb = x + b * t_len * d_in;
  const bf16* wkh = wk + head * DH;
  const bf16* wvh = wv + head * DH;
  const int nk = d_in / kBKF;

  auto load_stage = [&](int st, int k0) {
    const uint32_t s = base + st * SB;
    wipa::load_tile_async<64, kWgThreads>(s, xb + k0, d_in, t0, t_len, tid);
    wipa::load_tile_async<DH, kWgThreads>(s + XB, wkh, d, k0, d_in, tid);
    wipa::load_tile_async<DH, kWgThreads>(s + XB + WB, wvh, d, k0, d_in, tid);
  };

  // the running sums, and each k-tile's partial products
  float acc_k[DH / 2], acc_v[DH / 2], part_k[DH / 2], part_v[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = part_k[i] = part_v[i] = 0.f;

  load_stage(0, 0);
  wipa::cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) load_stage(st ^ 1, (t + 1) * kBKF);
    wipa::cp_async_commit();
    wipa::cp_async_wait<1>();  // k-tile t landed
    wipa::fence_proxy_async();
    __syncthreads();

    const uint32_t xs = base + st * SB;
    wipa::fence_regs(part_k);
    wipa::fence_regs(part_v);
    wipa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKF / 16; ++kk) {  // the first k-step starts afresh
      const uint64_t da = wipa::make_desc<64>(xs + 32 * kk);
      wgmma_xw<DH>(part_k, da, wipa::make_desc<DH>(xs + XB + kk * 16 * RB), kk > 0);
      wgmma_xw<DH>(part_v, da, wipa::make_desc<DH>(xs + XB + WB + kk * 16 * RB), kk > 0);
    }
    wipa::wgmma_commit();
    wipa::wgmma_wait_all();
    wipa::fence_regs(part_k);
    wipa::fence_regs(part_v);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      acc_k[i] += part_k[i];
      acc_v[i] += part_v[i];
    }
    __syncthreads();  // stage st is free for k-tile t + 2
  }

  // the ring is drained: stage its codes in stage 0's bytes
  uint8_t* const codes_k = base_ptr;
  uint8_t* const codes_v = base_ptr + DH * kCodeStride;
  const size_t bh = b * n_head + head;
  quantize_tile<DH>(acc_k, bk + head * DH, codes_k, ks + bh * t_pad, t0, t_len,
                    warp, lane);
  quantize_tile<DH>(acc_v, bv + head * DH, codes_v, vs + bh * t_pad, t0, t_len,
                    warp, lane);
  __syncthreads();
  // codes: DH rows of kBT contiguous bytes at [b, head, row, t0 : t0 + kBT]
  constexpr int kChunks = kBT / 16;
  for (int i = tid; i < 2 * DH * kChunks; i += kWgThreads) {
    const int tensor = i / (DH * kChunks);
    const int row = (i / kChunks) % DH;
    const int ch = i % kChunks;
    int8_t* dst = (tensor ? vc : kc) + (bh * DH + row) * t_pad + t0 + 16 * ch;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
        (tensor ? codes_v : codes_k) + row * kCodeStride + 16 * ch);
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* x, const void* wk, const void* bk,
                         const void* wv, const void* bv, void* kc, void* ks,
                         void* vc, void* vs, int batch, int t_len, int t_pad,
                         int d_in, int n_head, cudaStream_t stream) {
  constexpr int kSmem = wg_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kv_init_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_head, t_pad / kBT, batch);
  kv_init_wgmma<DH><<<grid, kWgThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<const float*>(bk), static_cast<const bf16*>(wv),
      static_cast<const float*>(bv), static_cast<int8_t*>(kc),
      static_cast<float*>(ks), static_cast<int8_t*>(vc),
      static_cast<float*>(vs), t_len, t_pad, d_in, n_head);
  return cudaGetLastError();
}

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kBK = 32;  // input features a K step
constexpr int kThreads = 256;

// grid (2 * H, T_pad / kBT, B): blockIdx.x = tensor * H + head, tensor 0 = K.
template <int DH>
__global__ void __launch_bounds__(kThreads)
kv_init_f32(const float* __restrict__ x, const float* __restrict__ wk,
            const float* __restrict__ bk, const float* __restrict__ wv,
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
  const float* w = tensor ? wv : wk;
  const float* bias = tensor ? bv : bk;
  int8_t* code_out = tensor ? vc : kc;
  float* scale_out = tensor ? vs : ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group; the 16 lanes of a half-warp
  const int ty = tid >> 4;  // row group
  const float* xb = x + b * t_len * d_in;

  float acc[4][kCols] = {};
  for (int k0 = 0; k0 < d_in; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;  // coalesced along the features
      const int t = t0 + r;
      xs[c][r] = t < t_len ? xb[static_cast<size_t>(t) * d_in + k0 + c] : 0.f;
    }
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      wt[r][c] = w[static_cast<size_t>(k0 + r) * d + head * DH + c];
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

  // epilogue: linear()'s bias add, then the per-(position, head) quantizer
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool valid = t0 + r < t_len;
    float y[kCols];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      y[j] = acc[i][j] + bias[head * DH + tx + 16 * j];
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

template <int DH>
cudaError_t launch_f32(const void* x, const void* wk, const void* bk,
                       const void* wv, const void* bv, void* kc, void* ks,
                       void* vc, void* vs, int batch, int t_len, int t_pad,
                       int d_in, int n_head, cudaStream_t stream) {
  const dim3 grid(2 * n_head, t_pad / kBT, batch);
  kv_init_f32<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<const float*>(bk), static_cast<const float*>(wv),
      static_cast<const float*>(bv), static_cast<int8_t*>(kc),
      static_cast<float*>(ks), static_cast<int8_t*>(vc),
      static_cast<float*>(vs), t_len, t_pad, d_in, n_head);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, t_len, d_in) f32 or bf16 (is_bf16); wk, wv: (d_in, n_head *
// dh) in x's type; bk, bv: (n_head * dh,) f32, already rounded to x's type;
// k_codes, v_codes: (batch, n_head, dh, t_pad) int8; k_scale, v_scale:
// (batch, n_head, t_pad) f32. t_pad % 128 == 0, t_pad >= t_len, dh in
// {32, 64}; d_in % 32 == 0 in f32, d_in % 64 == 0 in bf16 (whose operands
// are 16-byte aligned). Returns cudaGetLastError().
extern "C" int wipa_kv_init_int8(const void* x, const void* wk, const void* bk,
                                 const void* wv, const void* bv,
                                 void* k_codes, void* k_scale, void* v_codes,
                                 void* v_scale, int batch, int t_len,
                                 int t_pad, int d_in, int n_head, int dh,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || t_len <= 0 || t_pad % 128 || t_pad < t_len ||
      d_in % (is_bf16 ? kBKF : kBK) || n_head <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WIPA_KV_INIT(BODY, DH)                                                \
  BODY<DH>(x, wk, bk, wv, bv, k_codes, k_scale, v_codes, v_scale, batch,      \
           t_len, t_pad, d_in, n_head, s)
  if (dh == 64) {
    err = is_bf16 ? WIPA_KV_INIT(launch_wgmma, 64) : WIPA_KV_INIT(launch_f32, 64);
  } else if (dh == 32) {
    err = is_bf16 ? WIPA_KV_INIT(launch_wgmma, 32) : WIPA_KV_INIT(launch_f32, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIPA_KV_INIT
  return static_cast<int>(err);
}
