// Quantized-weight matrix products for Hopper (sm_90a): K6, the int8 x int8
// product with per-row activation quantization, and K7, the int4-weight
// product with group scales.
//
// K6 replaces: whisper_ipa_tpu/ops/quant_matmul.py, int8_matmul (:51,
// pallas_call :77, body _int8_matmul_kernel :30).
//   s[m]    = max(max_k |x[m, k]|, 1e-6) / 127
//   xq[m,k] = clip(round_half_even(x[m, k] / s[m]), -127, 127)     (int8)
//   y[m, n] = float(sum_k xq[m, k] * wq[k, n]) * s[m] * ws[n]      (f32)
// The sum is exact in int32 (|sum| <= K * 127^2 < 2^31 for K < 133,000).
//
// What bounds K6 on the H100: at the encoder's M = 24,000 rows the int8
// products (2*M*K*N, 28-113 GOP) over the tensor cores' 1979 TOP/s, or the
// f32 output over the memory rate, whichever is larger; at decode shapes
// (M = 16) the weight bytes and the launch. Design (simple first): pass 1
// quantizes each row once (one block a row, x read once, int8 codes and a
// scale written); pass 2 is a 64 x 64 output tile a block, 256 threads of
// 4 x 4 outputs each, the K loop in 32-byte steps through shared memory,
// the weights repacked there as four K-adjacent bytes to a word so that
// each multiply-add is one __dp4a on the CUDA cores. Tensor-core (mma.sync
// / wgmma s8) versions are later work.
//
// K7 replaces: whisper_ipa_tpu/ops/quant_matmul.py, int4_matmul (:152,
// pallas_call :190, body _int4_matmul_kernel :115).
//   byte wp[r, n] holds input row 2r in its low nibble, 2r+1 in its high
//   (sign-extended 4-bit codes); ws[g, n] is the scale of group g = r / rpg
//   y[m, n] = sum_r x[m, 2r] * (lo * ws) + x[m, 2r+1] * (hi * ws)   (f32)
// What bounds K7: at the decode shapes it serves (M = 16-64) the packed
// weight bytes (K/2 * N, 0.3-1.2 MB, a few tenths of a microsecond at
// 3.35 TB/s) and, in practice, the launch. Design: a block owns 32 output
// columns (one per lane) and 16 rows; its 8 warps split the packed rows,
// each lane dequantizes its column's byte once in registers and applies it
// to all 16 rows, whose x values sit in shared memory as f32; the warps'
// partial sums are added in shared memory at the end. The dequantized
// weights never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// -- K6 pass 1: per-row activation quantization -----------------------------

constexpr int kRowThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int k) {
  __shared__ float scratch[kRowThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kRowThreads) {
    amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = scratch[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) amax = fmaxf(amax, scratch[w]);
  const float s = fmaxf(amax, 1e-6f) / 127.0f;
  int8_t* qr = xq + row * k;
  for (int i = threadIdx.x; i < k; i += kRowThreads) {
    const float c = fminf(fmaxf(rintf(to_f32(xr[i]) / s), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(c);
  }
  if (threadIdx.x == 0) xs[row] = s;
}

// -- K6 pass 2: int8 x int8 -> int32 product, rescaled to f32 ----------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 8;  // K step in 4-byte words (32 bytes)
constexpr int kGemmThreads = 256;

__global__ void __launch_bounds__(kGemmThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 float* __restrict__ out, int m, int k, int n) {
  __shared__ int as[kBM][kBKW + 1];  // x codes, 4 K-adjacent bytes a word
  __shared__ int bs[kBKW][kBN];      // w codes, repacked the same way
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kw_total = k / 4;
  const int* xw = reinterpret_cast<const int*>(xq);

  int acc[4][4] = {};
  for (int kw0 = 0; kw0 < kw_total; kw0 += kBKW) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / kBKW, w = idx % kBKW;
      const int gr = m0 + r, gw = kw0 + w;
      as[r][w] = (gr < m && gw < kw_total)
                     ? xw[static_cast<size_t>(gr) * kw_total + gw] : 0;
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int w = idx / kBN, c = idx % kBN;
      const int gw = kw0 + w, gc = n0 + c;
      int packed = 0;
      if (gw < kw_total && gc < n) {
        const int8_t* src = wq + static_cast<size_t>(4 * gw) * n + gc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          packed |= (static_cast<int>(src[static_cast<size_t>(j) * n]) & 0xff)
                    << (8 * j);
        }
      }
      bs[w][c] = packed;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kBKW; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
    const float sx = xs[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) {
        out[static_cast<size_t>(r) * n + c] =
            static_cast<float>(acc[i][j]) * sx * ws[c];
      }
    }
  }
}

// -- K7: int4 weights, group scales, f32 product -----------------------------

constexpr int kI4Rows = 16;    // output rows a block
constexpr int kI4Warps = 8;    // split of the packed rows
constexpr int kI4Chunk = 256;  // input features staged in shared memory

template <typename T>
__global__ void __launch_bounds__(kI4Warps * 32)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int m, int k, int n, int rows_per_group) {
  __shared__ float xs[kI4Rows][kI4Chunk];
  __shared__ float red[kI4Warps][kI4Rows][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kI4Rows;
  const bool col_ok = col < n;

  float acc[kI4Rows] = {};
  for (int c0 = 0; c0 < k; c0 += kI4Chunk) {
    const int width = min(kI4Chunk, k - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < kI4Rows * kI4Chunk; i += kI4Warps * 32) {
      const int r = i / kI4Chunk, c = i % kI4Chunk;
      xs[r][c] = (m0 + r < m && c < width)
                     ? to_f32(x[static_cast<size_t>(m0 + r) * k + c0 + c]) : 0.f;
    }
    __syncthreads();
    // packed rows of this chunk: input features c0 + 2j, c0 + 2j + 1
    for (int j = warp; j < width / 2; j += kI4Warps) {
      const int r = c0 / 2 + j;
      float lo = 0.f, hi = 0.f;
      if (col_ok) {
        const int v = wp[static_cast<size_t>(r) * n + col];
        const float s = ws[static_cast<size_t>(r / rows_per_group) * n + col];
        lo = static_cast<float>(static_cast<int>(static_cast<unsigned>(v) << 28) >> 28) * s;
        hi = static_cast<float>(static_cast<int>(static_cast<unsigned>(v) << 24) >> 28) * s;
      }
#pragma unroll
      for (int i = 0; i < kI4Rows; ++i) {
        acc[i] = fmaf(xs[i][2 * j], lo, acc[i]);
        acc[i] = fmaf(xs[i][2 * j + 1], hi, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kI4Rows; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kI4Rows * 32; i += kI4Warps * 32) {
    const int r = i / 32, l = i % 32;
    const int gr = m0 + r, gc = blockIdx.x * 32 + l;
    if (gr >= m || gc >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kI4Warps; ++w) s += red[w][r][l];
    out[static_cast<size_t>(gr) * n + gc] = s;
  }
}

}  // namespace

// K6. x: (m, k) f32 or bf16 (is_bf16); w_codes: (k, n) int8; w_scale: (n,)
// f32; out: (m, n) f32; x_codes: (m, k) int8 and x_scale: (m,) f32 scratch.
// k % 4 == 0. Returns cudaGetLastError().
extern "C" int wipa_int8_matmul(const void* x, const void* w_codes,
                                const void* w_scale, void* out, void* x_codes,
                                void* x_scale, int m, int k, int n,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0 || k <= 0 || k % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<m, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x_codes),
        static_cast<float*>(x_scale), k);
  } else {
    quantize_rows_kernel<float><<<m, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(x_codes),
        static_cast<float*>(x_scale), k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(
      static_cast<const int8_t*>(x_codes), static_cast<const float*>(x_scale),
      static_cast<const int8_t*>(w_codes), static_cast<const float*>(w_scale),
      static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// K7. x: (m, k) f32 or bf16 (is_bf16); w_packed: (k/2, n) int8; w_scale:
// (k/2 / rows_per_group, n) f32; out: (m, n) f32. k even, (k/2) %
// rows_per_group == 0. Returns cudaGetLastError().
extern "C" int wipa_int4_matmul(const void* x, const void* w_packed,
                                const void* w_scale, void* out, int m, int k,
                                int n, int rows_per_group, int is_bf16,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0 || k <= 0 || k % 2 || rows_per_group <= 0 ||
      (k / 2) % rows_per_group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + 31) / 32, (m + kI4Rows - 1) / kI4Rows);
  if (is_bf16) {
    int4_matmul_kernel<__nv_bfloat16><<<grid, kI4Warps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const int8_t*>(w_packed),
        static_cast<const float*>(w_scale), static_cast<float*>(out), m, k, n,
        rows_per_group);
  } else {
    int4_matmul_kernel<float><<<grid, kI4Warps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_packed),
        static_cast<const float*>(w_scale), static_cast<float*>(out), m, k, n,
        rows_per_group);
  }
  return static_cast<int>(cudaGetLastError());
}
