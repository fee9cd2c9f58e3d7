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
// What bounds it on the H100: the products, 2 * B * T * d_in * 2d for the
// pair, over the tensor cores' bf16 rate: 1.81 TFLOP, 1.83 ms a layer for
// whisper-small at batch 512 (d 768), 1.26 TFLOP, 1.27 ms for
// whisper-large-v3 at batch 128 (d 1280). The bytes (x once, the weights,
// int8 codes, scales) are ~2.4 GB and ~0.9 GB, ~0.7 and ~0.3 ms.
//
// bf16 design: one GEMM of x, (B * T_pad) rows, against [Wk | Wv], 2d
// columns, whose epilogue quantizes each 64 (Dh) columns of a row. x is the
// K-major operand; the weights are read as they are stored, (d_in, d) with
// the columns contiguous, through one tensor map each, as the MN-major B
// operand (wgmma's transpose bit), so nothing is copied before the launch.
// A tile is 128 positions of one batch row x 256 columns (four heads' K or
// V at Dh 64), so one x tile feeds four heads.
// A persistent grid of one block an SM walks the tiles, columns fastest,
// so the blocks in flight share their x rows in L2 and the weights stay
// there. A block is a producer warpgroup and two consumer warpgroups:
// - the producer's one thread keeps a ring of 4 stages full with TMA loads
//   (the x tile, 128 x 64 features, and the weight tile, 64 features x 256
//   columns as four 64-column boxes, each from Wk or Wv; all 128-byte
//   swizzled), each stage on a "full" mbarrier counting its bytes
//   and an "empty" one that the 8 consumer warps arrive at; it runs ahead
//   into the next tile while the consumers quantize;
// - each consumer warpgroup owns 64 of the 128 positions and all 256
//   columns: a 64 x 256 f32 running sum, 128 registers a thread. A 64-feature
//   k-tile is multiplied one 128-column half at a time (four m64n128k16
//   wgmmas into a fresh partial), and each partial is added to the running
//   sum on the CUDA cores: one accumulator carried through all the k-steps
//   left three times as many codes off the plain version's (bf16 roundings
//   of the projection falling the other way), and with the bias a code two
//   steps off at an equal scale (PERF.md section 6). While one warpgroup
//   adds, the other's products keep the tensor cores busy.
// Epilogue in registers: wgmma's accumulator gives each quad of lanes one
// position's columns, so linear()'s two roundings and the bias apply in
// place and a (position, head) maximum takes two shuffles; the codes of a
// 128-column half are staged transposed in shared memory and leave as 64
// contiguous bytes a (head dim, warpgroup) row, T already minor. Codes and
// scales are written through the pointers given, so the caller can pass
// one layer's views of a stacked cache.
//
// f32 keeps the CUDA-core body (TF32 would miss the f32 bound): one block
// computes a 64-position x Dh tile of K or V, whole heads, in a classic
// shared-memory tile loop (32-deep K steps, 4 x Dh/16 outputs a thread,
// f32 FMAs), the maximum over the 16 lanes that share a row; grid (2 * H,
// T_pad / 64, B), the 2 * H tiles of one x tile side by side.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBT = 64;  // positions a block of the f32 body

// -- bf16: TMA ring, wgmma ----------------------------------------------------

constexpr int kTileT = 128;                       // positions a tile
constexpr int kTileN = 256;                       // columns of [K | V] a tile
constexpr int kHalfN = 128;                       // columns a partial product
constexpr int kKT = 64;                           // input features a k-tile
constexpr int kStages = 4;
constexpr int kXBytes = kTileT * kKT * 2;         // 16 KB
constexpr int kWBytes = kTileN * kKT * 2;         // 32 KB
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kStageRow = 64 + 16;                // bytes a staged code row
constexpr int kStagingBytes = 2 * kHalfN * kStageRow;  // one half, both warpgroups
constexpr int kTmaSmem = 1024 + kStages * kStageBytes + kStagingBytes + 2 * kStages * 8;
constexpr int kConsumerWarps = 8;                 // two warpgroups
constexpr int kTmaThreads = 32 * (kConsumerWarps + 4);  // and the producer's
// registers a thread after the rebalancing: 168 at launch (65,536 over 384
// threads); the producer gives 128 back, the consumers take them
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the 128 threads of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

#define WIPA_D8(b)                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),      \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 128) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared,
// MN-major: 16 rows of 64-column boxes, read with the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : WIPA_D8(0), WIPA_D8(8), WIPA_D8(16), WIPA_D8(24), WIPA_D8(32),
        WIPA_D8(40), WIPA_D8(48), WIPA_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef WIPA_D8

constexpr int kWBoxCols = 64;                     // columns a weight box
constexpr int kWBoxBytes = kKT * kWBoxCols * 2;   // 8 KB

// the B descriptor of 128 MN-major columns: two weight boxes, 128-byte
// swizzled; the leading offset steps to the second box, the stride offset
// to the next 8 features
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  return (wipa::make_desc<64>(addr) & ~(0x3FFFull << 16)) |
         (static_cast<uint64_t>(kWBoxBytes >> 4) << 16);
}

// grid: min(tiles, SMs) blocks of kTmaThreads; tile i is column tile
// i % n_col_tiles of row tile i / n_col_tiles, row tile r being positions
// (r % (t_pad / 128)) * 128 of batch row r / (t_pad / 128). Warps 0-7 are
// the consumers (warpgroup w: positions 64 w to 64 w + 63), warpgroup 2
// the producer, whose first thread issues the loads. The running sum and
// a partial (192 registers) need the consumers' 232 registers: at the
// launch's 168 they spilled.
template <int DH>
__global__ void __launch_bounds__(kTmaThreads, 1)
kv_init_tma(const __grid_constant__ CUtensorMap x_map,
            const __grid_constant__ CUtensorMap wk_map,
            const __grid_constant__ CUtensorMap wv_map,
            const bf16* __restrict__ bk, const bf16* __restrict__ bv,
            int8_t* __restrict__ kc, float* __restrict__ ks,
            int8_t* __restrict__ vc, float* __restrict__ vs, int t_len,
            int t_pad, int d_in, int n_head, int n_tiles, int n_col_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle wants 1024-byte tiles
  uint8_t* const staging = smem_raw + (base - raw) + kStages * kStageBytes;
  const uint32_t full = base + kStages * kStageBytes + kStagingBytes;
  const uint32_t empty = full + 8 * kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nk = d_in / kKT;
  const int row_tiles = t_pad / kTileT;  // of one batch row
  const int d = n_head * DH;
  const int n_cols = 2 * d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int ct = tile % n_col_tiles;
        const int rt = tile / n_col_tiles;
        const int b = rt / row_tiles;
        const int t0 = (rt % row_tiles) * kTileT;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // the first round passes
          // boxes past 2d are not loaded: their columns are never stored
          const int boxes = min(kTileN, n_cols - ct * kTileN) / kWBoxCols;
          mbar_expect_tx(full + 8 * s, kXBytes + boxes * kWBoxBytes);
          const uint32_t st = base + s * kStageBytes;
          // positions past T arrive as zeros
          tma_load_3d(st, &x_map, full + 8 * s, k * kKT, t0, b);
          for (int c = 0; c < boxes; ++c) {
            const int gc = ct * kTileN + c * kWBoxCols;
            const uint32_t dst = st + kXBytes + c * kWBoxBytes;
            if (gc < d) {
              tma_load_2d(dst, &wk_map, full + 8 * s, gc, k * kKT);
            } else {
              tma_load_2d(dst, &wv_map, full + 8 * s, gc - d, k * kKT);
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;  // within the warpgroup
  const int quad = lane & 3;
  uint8_t* const stage_rows = staging + wg * kHalfN * kStageRow;

  // acc[64 h + 4 j + 2 i + c]: position 16 (warp % 4) + lane / 4 + 8 i of
  // this warpgroup's 64, column 128 h + 8 j + 2 quad + c of the tile
  float acc[kTileN / 2];
  float part[kHalfN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ct = tile % n_col_tiles;
    const int rt = tile / n_col_tiles;
    const size_t b = rt / row_tiles;
    const int t0 = (rt % row_tiles) * kTileT + 64 * wg;  // this warpgroup's first position

#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t xs = base + s * kStageBytes + wg * (kXBytes / 2);
      const uint32_t ws = base + s * kStageBytes + kXBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wipa::fence_regs(part);
        wipa::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {  // the first k-step starts afresh
          wgmma_m64n128k16(part, wipa::make_desc<64>(xs + 32 * kk),
                           weight_desc(ws + h * (kWBytes / 2) + kk * 16 * 2 * kWBoxCols),
                           kk > 0);
        }
        wipa::wgmma_commit();
        wipa::wgmma_wait_all();
        wipa::fence_regs(part);
#pragma unroll
        for (int i = 0; i < kHalfN / 2; ++i) acc[64 * h + i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
    }

    // epilogue, one 128-column half at a time through the staging rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = ct * kTileN + h * kHalfN;  // the half's first column
#pragma unroll
      for (int g = 0; g < kHalfN / DH; ++g) {  // one head of K or V
        const int gc = c0 + g * DH;
        if (gc >= n_cols) continue;  // the same for the whole warp
        const bool is_v = gc >= d;
        const int hc = gc - (is_v ? d : 0);  // column within K or V
        const bf16* bias = is_v ? bv : bk;
        float amax[2] = {0.f, 0.f};
        // constant trip counts, so that every acc index is known once the
        // loops are unrolled and acc stays in registers
#pragma unroll
        for (int jj = 0; jj < DH / 8; ++jj) {
          const int j = g * (DH / 8) + jj;
          float bj[2] = {0.f, 0.f};
          if (bias != nullptr) {
            const int col = hc + 8 * jj + 2 * quad;
            bj[0] = __bfloat162float(bias[col]);
            bj[1] = __bfloat162float(bias[col + 1]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int reg = 64 * h + 4 * j + r;
            acc[reg] = round_bf16(round_bf16(acc[reg]) + bj[r & 1]);
            amax[r >> 1] = fmaxf(amax[r >> 1], fabsf(acc[reg]));
          }
        }
        float* scale = (is_v ? vs : ks) + (b * n_head + hc / DH) * t_pad + t0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
          amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
          const int row = 16 * (warp & 3) + (lane >> 2) + 8 * i;
          const bool valid = t0 + row < t_len;
          const float sc = fmaxf(amax[i], 1e-8f) / 127.0f;
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj) {
            const int j = g * (DH / 8) + jj;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int q = __float2int_rn(acc[64 * h + 4 * j + 2 * i + c] / sc);
              stage_rows[(8 * j + 2 * quad + c) * kStageRow + row] =
                  valid ? static_cast<uint8_t>(q) : 0;
            }
          }
          if (quad == 0) scale[row] = valid ? sc : 0.f;
        }
      }
      warpgroup_sync(wg);
      // a column's 64 positions: 4 chunks of 16 bytes at [b, head, dh, t0 : t0 + 64]
#pragma unroll
      for (int p = 0; p < kHalfN * 4 / 128; ++p) {
        const int chunk = tid + 128 * p;
        const int gc = c0 + (chunk >> 2);
        if (gc < n_cols) {
          const bool is_v = gc >= d;
          const int hc = gc - (is_v ? d : 0);
          int8_t* dst = (is_v ? vc : kc) + (b * d + hc) * t_pad + t0 + 16 * (chunk & 3);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
              stage_rows + (chunk >> 2) * kStageRow + 16 * (chunk & 3));
        }
      }
      warpgroup_sync(wg);  // the staging rows are free for the next half
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 tensor map with a 128-byte swizzled box whose rows are 64 elements
bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_tma(const void* x, const void* wk, const void* wv,
                       const void* bk, const void* bv, void* kc, void* ks, void* vc,
                       void* vs, int batch, int t_len, int t_pad, int d_in,
                       int n_head, int device, cudaStream_t stream) {
  const int n_cols = 2 * n_head * DH;
  CUtensorMap x_map, wk_map, wv_map;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(d_in),
                                static_cast<cuuint64_t>(t_len),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[2] = {2ull * d_in, 2ull * d_in * t_len};
  const cuuint32_t x_box[3] = {kKT, kTileT, 1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(n_head * DH),
                                static_cast<cuuint64_t>(d_in)};
  const cuuint64_t w_strides[1] = {2ull * n_head * DH};
  const cuuint32_t w_box[2] = {kWBoxCols, kKT};
  if (!bf16_map(&x_map, x, 3, x_dims, x_strides, x_box) ||
      !bf16_map(&wk_map, wk, 2, w_dims, w_strides, w_box) ||
      !bf16_map(&wv_map, wv, 2, w_dims, w_strides, w_box)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kv_init_tma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
  if (err != cudaSuccess) return err;
  const int n_col_tiles = (n_cols + kTileN - 1) / kTileN;
  const int n_tiles = batch * (t_pad / kTileT) * n_col_tiles;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kv_init_tma<DH><<<grid, kTmaThreads, kTmaSmem, stream>>>(
      x_map, wk_map, wv_map, static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
      static_cast<int8_t*>(kc), static_cast<float*>(ks), static_cast<int8_t*>(vc),
      static_cast<float*>(vs), t_len, t_pad, d_in, n_head, n_tiles, n_col_tiles);
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

// bf16: x (batch, t_len, d_in); wk, wv: (d_in, n_head dh); bk, bv:
// (n_head dh,) bf16, or null for no bias; k_codes, v_codes: (batch, n_head,
// dh, t_pad) int8; k_scale, v_scale: (batch, n_head, t_pad) f32. t_pad %
// 128 == 0, t_pad >= t_len, t_pad - t_len < 128, dh in {32, 64}, d_in % 64
// == 0, n_head dh % 64 == 0; x, the weights and the codes 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int wipa_kv_init_bf16(const void* x, const void* wk, const void* wv,
                                 const void* bk, const void* bv, void* k_codes,
                                 void* k_scale, void* v_codes, void* v_scale,
                                 int batch, int t_len, int t_pad, int d_in,
                                 int n_head, int dh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || t_len <= 0 || t_pad % kTileT || t_pad < t_len ||
      t_pad - t_len >= kTileT || d_in % kKT || n_head <= 0 ||
      (n_head * dh) % kWBoxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    err = launch_tma<64>(x, wk, wv, bk, bv, k_codes, k_scale, v_codes, v_scale, batch,
                         t_len, t_pad, d_in, n_head, device, s);
  } else if (dh == 32) {
    err = launch_tma<32>(x, wk, wv, bk, bv, k_codes, k_scale, v_codes, v_scale, batch,
                         t_len, t_pad, d_in, n_head, device, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// f32: x (batch, t_len, d_in); wk, wv: (d_in, n_head * dh); bk, bv:
// (n_head * dh,) f32; codes and scales as above. t_pad % 128 == 0, t_pad
// >= t_len, dh in {32, 64}, d_in % 32 == 0. Returns cudaGetLastError().
extern "C" int wipa_kv_init_f32(const void* x, const void* wk, const void* bk,
                                const void* wv, const void* bv, void* k_codes,
                                void* k_scale, void* v_codes, void* v_scale,
                                int batch, int t_len, int t_pad, int d_in,
                                int n_head, int dh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || t_len <= 0 || t_pad % 128 || t_pad < t_len || d_in % kBK ||
      n_head <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    err = launch_f32<64>(x, wk, bk, wv, bv, k_codes, k_scale, v_codes, v_scale,
                         batch, t_len, t_pad, d_in, n_head, s);
  } else if (dh == 32) {
    err = launch_f32<32>(x, wk, bk, wv, bv, k_codes, k_scale, v_codes, v_scale,
                         batch, t_len, t_pad, d_in, n_head, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
