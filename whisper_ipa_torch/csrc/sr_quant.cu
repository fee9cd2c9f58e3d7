// Stochastic-rounding int8 weight quantization for Hopper (sm_90a).
//
// Replaces: whisper_ipa_tpu/ops/sr_quant.py, stochastic_quantize_int8
// (:69, pallas_call :94, body _sr_quant_kernel :34).
//
// w (in, out) f32, row-major -> codes (in, out) int8 and scales (out,) f32:
//   s[o] = max(max_i |w[i, o]|, 1e-8) / 127
//   q[i, o] = clip(floor(w[i, o] / s[o] + u), -127, 127),  u in [0, 1)
// Both divisions are IEEE (nvcc's default -prec-div=true; this file must
// not be built with --use_fast_math): a reciprocal product would move a
// scale or a quotient by an ulp, and with it a code. So the scales equal
// the host quantizer's (ops/quant.quantize_linear) on every column that
// is not all zero, and the codes equal the plain PyTorch version's
// (ops/sr_quant.stochastic_quantize_int8_plain) bit for bit.
//
// Random numbers: a counter-based Philox4x32-10 (Salmon et al., SC'11;
// the Random123 constants), key (seed, 0), counter (col, row, 0, 0), word 0.
// A code's bits are a pure function of (seed, row, col), so they do not
// depend on the grid, and the plain version recomputes them exactly. u is
// built as the TPU kernel builds it: the top 23 bits as a mantissa in
// [1, 2), minus 1. (The TPU kernel padded rows and columns to its tiles;
// nothing here needs that.)
//
// What bounds it on the H100: bytes. It reads 4 B and writes 1 B a
// weight: 11.8 MB for a (768, 3072) weight, 3.5 us at 3.35 TB/s; the
// Philox rounds are ~40 integer operations an element, far below the
// card's rate. Design: one block of 32 x 16 threads owns 32 columns; a
// warp's 32 lanes read 32 neighbouring floats of one row (128 B), so both
// passes are coalesced. Pass 1 reduces max|w| down each column (16 row
// strides, then shared memory); pass 2 reads w again (from L2) and writes
// the codes. Small weights give small grids ((768, 768) is 24 blocks), so
// a launch is far from its bound; simple first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;     // columns a block (= lanes of a warp)
constexpr int kRowLanes = 16; // row strides a block (warps)

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// Philox4x32-10: word 0 of the block at counter (c0, c1, 0, 0), key (k0, 0).
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t k0) {
  uint32_t c2 = 0u, c3 = 0u, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0);
    const uint32_t lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2);
    const uint32_t lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__global__ void __launch_bounds__(kCols * kRowLanes)
sr_quant_kernel(const float* __restrict__ w, int8_t* __restrict__ q,
                float* __restrict__ s, int rows, int cols, uint32_t seed) {
  __shared__ float red[kRowLanes][kCols];
  __shared__ float scale[kCols];

  const int col = blockIdx.x * kCols + threadIdx.x;
  const bool live = col < cols;

  float amax = 0.0f;
  if (live) {
    for (int r = threadIdx.y; r < rows; r += kRowLanes)
      amax = fmaxf(amax, fabsf(w[static_cast<size_t>(r) * cols + col]));
  }
  red[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int i = 1; i < kRowLanes; ++i) amax = fmaxf(amax, red[i][threadIdx.x]);
    const float sc = fmaxf(amax, 1e-8f) / 127.0f;  // IEEE division
    scale[threadIdx.x] = sc;
    if (live) s[col] = sc;
  }
  __syncthreads();
  if (!live) return;

  const float sc = scale[threadIdx.x];
  for (int r = threadIdx.y; r < rows; r += kRowLanes) {
    const size_t i = static_cast<size_t>(r) * cols + col;
    const uint32_t bits = philox_word0(static_cast<uint32_t>(col),
                                       static_cast<uint32_t>(r), seed);
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float x = w[i] / sc;  // IEEE division
    const float f = floorf(__fadd_rn(x, u));
    q[i] = static_cast<int8_t>(fminf(fmaxf(f, -127.0f), 127.0f));
  }
}

}  // namespace

// w: (rows, cols) f32 contiguous; q: (rows, cols) int8; s: (cols,) f32.
// rows, cols >= 1. seed: the Philox key word 0.
// Returns cudaGetLastError().
extern "C" int wipa_sr_quant_int8(const void* w, void* q, void* s, int rows,
                                  int cols, unsigned int seed, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kCols - 1) / kCols);
  const dim3 block(kCols, kRowLanes);
  sr_quant_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<int8_t*>(q),
      static_cast<float*>(s), rows, cols, seed);
  return static_cast<int>(cudaGetLastError());
}
