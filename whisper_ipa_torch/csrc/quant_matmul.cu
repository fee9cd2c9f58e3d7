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
// What bounds K6 on the H100: at the encoder's M = 24,000 rows the bytes
// (x in, the f32 output out: 0.03 ms), the int8 products (2*M*K*N, 28-113
// GOP, 0.014-0.057 ms at the tensor cores' 1979 TOP/s) close behind; at
// decode shapes (M <= 64) the weight bytes (0.6-2.4 MB, under a
// microsecond) and, in practice, the launch and the latency of one pass
// over the weights.
//
// Both bodies multiply on the int8 tensor cores with
// mma.sync.m16n8k32.s8 (row x col, s32 sums): its B fragment is four
// K-adjacent codes of one column to a 32-bit word, and w_q (K, N) is
// N-major, so each thread loads four K-adjacent rows of 16 columns with
// 16-byte loads and transposes them in registers (__byte_perm) into
// sixteen such words, stored n-major in shared memory; x codes are
// row-major already. Both tiles are 128-byte rows under Tile<64>'s swizzle
// (attention_tiles.cuh), which ldmatrix reads without bank conflicts as
// A fragments (rows) and B fragments (columns). wgmma's s8 form wants both
// operands K-major in shared memory too, with descriptors and a larger
// tile for the same transposition; mma.sync needs neither and serves the
// 16-row decode tiles as well, so it is used for both. The integer sums
// are exact in any order and split, and the rescale is the plain
// version's, float(acc) * s[m] * w_scale[n] in that order, so both bodies
// equal int8_matmul_plain bit for bit.
//
// Large M (> the wrapper's threshold): pass 1 quantizes the rows (a warp a
// row, vector loads) into an int8 scratch whose rows are padded to 16
// bytes; pass 2 is a 128 x 128 output tile a block, 8 warps of 64 x 32,
// the K loop in 128-byte tiles through a two-stage ring (x codes by
// cp.async, weights through registers, the next tile in flight while this
// one is multiplied).
//
// Small M (<= 64, decode): one launch. A thread-block cluster of up to 8
// blocks splits K; each block owns 32 output columns and one K slice. It
// requests its first weight patch, takes its rows' partial maxima over its
// slice, reads the others' over distributed shared memory (so each row's
// scale is the whole row's, as in pass 1), quantizes its slice of x into
// shared memory, multiplies, and leaves its int32 partial sums in shared
// memory; after a cluster barrier each block adds the cluster's partials
// for its share of the rows and writes them rescaled. At N = 768, K = 768
// that is 24 x 6 = 144 blocks streaming the weights, no scratch, no second
// launch.
//
// K7 replaces: whisper_ipa_tpu/ops/quant_matmul.py, int4_matmul (:152,
// pallas_call :190, body _int4_matmul_kernel :115).
//   byte wp[r, n] holds input row 2r in its low nibble, 2r+1 in its high
//   (sign-extended 4-bit codes); ws[g, n] is the scale of group g = r / rpg
//   y[m, n] = sum_r x[m, 2r] * (lo * ws) + x[m, 2r+1] * (hi * ws)   (f32)
// What bounds K7: at the decode shapes it serves (M = 16-64) the packed
// weight bytes (K/2 * N, 0.3-1.2 MB, a few tenths of a microsecond at
// 3.35 TB/s) and the f32 FMAs (2 M K N, about a microsecond at 67 TFLOP/s),
// and, in practice, the launch and the latency of one pass over the
// weights: the work is too small to hide a serial chain of loads.
//
// Small M (<= 64, decode and the prefix step): one launch that fills the
// card. A block of 128 threads owns 32 output columns, 16 rows and one K
// slice of whole 16-row multiples of packed rows; a thread-block cluster of
// up to 8 blocks splits K, so (16, 3072) x (1536, 768) runs 192 blocks. A
// block copies its slice of packed weights, the group scales that serve it
// (each group's row once) and its x rows into shared memory with 16-byte
// cp.async, then each thread takes four columns (one 32-bit word of packed
// bytes: eight codes) of every 16th packed row, turns the codes into floats
// without int-to-float conversions (code + 8 as the low mantissa byte of
// 2^23, less 2^23 + 8: exact), dequantizes them once (code * scale in f32,
// the plain version's product) and applies them to all 16 rows with f32
// FMAs. The 16 threads of a column quad add their sums through shuffles
// and shared memory; each block writes its partial sums into the shared
// memory of the cluster's rank 0, one cluster barrier publishes them, and
// rank 0 adds them in rank order and writes out. No scratch tensor and no
// second launch.
//
// Larger M: a block owns 32 output columns (one per lane) and 16 rows; its
// 8 warps split the packed rows, each lane dequantizes its column's byte
// once in registers and applies it to all 16 rows, whose x values sit in
// shared memory as f32; the warps' partial sums are added in shared memory
// at the end. The dequantized weights never reach device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// -- K6: int8 tiles ----------------------------------------------------------

constexpr int kKT = 128;  // K codes a tile: one 128-byte row

// the byte offset of code (row, k) in a 128-byte-row tile, swizzled
__device__ __forceinline__ uint32_t tile_off(int row, int k) {
  return wipa::swz<64>(row * kKT + k);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four words of four row-bytes each (rows r0..r3, byte j = column j) ->
// four words of four column-bytes each (column j, byte i = row i).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);  // r2.2 r3.2 r2.3 r3.3
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Weight codes w[k0 + i][n0 .. n0 + 16) for i < 4: 16-byte loads when vec
// (N % 16 == 0 and w 16-byte aligned), else bytes; rows at or past k_end
// and columns at or past n read 0.
__device__ __forceinline__ void load_w_patch(uint32_t (&r)[4][4],
                                             const int8_t* __restrict__ w,
                                             int k0, int k_end, int n0, int n,
                                             bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + i;
    const int8_t* row = w + static_cast<size_t>(k) * n;
    if (k < k_end && vec && n0 + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + n0);
      r[i][0] = v.x;
      r[i][1] = v.y;
      r[i][2] = v.z;
      r[i][3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 4 * q + j;
          if (k < k_end && c < n) {
            v |= static_cast<uint32_t>(static_cast<uint8_t>(row[c])) << (8 * j);
          }
        }
        r[i][q] = v;
      }
    }
  }
}

// The patch's sixteen columns, each as the word of its four K-adjacent
// codes (k-quad kq of the tile), into the n-major tile at rows n_local +
// j. Odd column groups store j ^ 4 first, so a warp's two halves, 16 rows
// apart, fall in the two halves of the banks.
__device__ __forceinline__ void store_w_patch(uint32_t tile,
                                              const uint32_t (&r)[4][4],
                                              int n_local, int kq, bool odd) {
  uint32_t col[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    transpose4x4(r[0][q], r[1][q], r[2][q], r[3][q], col + 4 * q);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int jj = odd ? (j ^ 4) : j;
    st_shared_u32(tile + tile_off(n_local + jj, 4 * kq), odd ? col[j ^ 4] : col[j]);
  }
}

// four consecutive x values as f32 (8-byte bf16 or 16-byte f32 loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

// clip(round_half_even(v / s), -127, 127), IEEE divisions, packed low first
__device__ __forceinline__ uint32_t quantize4(float4 v, float s) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(f[j] / s), -127.f), 127.f));
    word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
  }
  return word;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// -- K6, large M: pass 1, the rows' scales and codes --------------------------

constexpr int kRowWarps = 8;  // rows a block, a warp each

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int m, int k, int ldq) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const T* xr = x + static_cast<size_t>(row) * k;
  float amax = 0.f;
  for (int c = 4 * lane; c < k; c += 128) amax = amax4(amax, load4(xr + c));
  const float s = fmaxf(warp_max(amax), 1e-6f) / 127.0f;
  int8_t* qr = xq + static_cast<size_t>(row) * ldq;
  for (int c = 4 * lane; c < k; c += 128) {
    *reinterpret_cast<uint32_t*>(qr + c) = quantize4(load4(xr + c), s);
  }
  if (lane == 0) xs[row] = s;
}

// -- K6, large M: pass 2, 128 x 128 tiles on mma.sync -------------------------

constexpr int kTM = 128;
constexpr int kTN = 128;
constexpr int kTThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kTTile = kTM * kKT;  // bytes of an A or a B tile
constexpr int kTSmem = 2 * 2 * kTTile + 1024;  // two stages of A and B

__global__ void __launch_bounds__(kTThreads)
int8_gemm_tiled(const int8_t* __restrict__ xq, int ldq,
                const float* __restrict__ xs, const int8_t* __restrict__ wq,
                const float* __restrict__ ws, float* __restrict__ out, int m,
                int k, int n, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s: A, then B

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int wm = warp >> 2;  // rows 64 wm .. of the tile
  const int wn = warp & 3;   // columns 32 wn ..
  // this thread's weight patch: k-quad kq, 16-column group ng; a warp's
  // half-warps take adjacent groups, so each row read is 32 bytes
  const int kq = (lane & 15) + 16 * (warp >> 2);
  const int ng = 2 * (warp & 3) + (lane >> 4);
  const int nt = (k + kKT - 1) / kKT;

  auto load_a = [&](int st, int k0) {
    const uint32_t dst = base + st * 2 * kTTile;
#pragma unroll
    for (int i = 0; i < kTM * (kKT / 16) / kTThreads; ++i) {
      const int c = tid + i * kTThreads;
      const int r = c >> 3, ch = c & 7;
      const int row = m0 + r, kb = k0 + 16 * ch;
      const int bytes = row < m ? max(0, min(16, k - kb)) : 0;
      // a chunk that reads nothing keeps an address inside the scratch
      const int8_t* src = xq + (bytes ? static_cast<size_t>(row) * ldq + kb : 0);
      wipa::cp_async16(dst + tile_off(r, 16 * ch), src, bytes);
    }
  };

  int acc[4][4][4] = {};  // [m16 tile][n8 tile][fragment]
  uint32_t wr[4][4];      // the next k-tile's weight patch, in flight
  load_a(0, 0);
  wipa::cp_async_commit();
  load_w_patch(wr, wq, 4 * kq, k, n0 + 16 * ng, n, vec);
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    const uint32_t a_s = base + st * 2 * kTTile;
    const uint32_t b_s = a_s + kTTile;
    store_w_patch(b_s, wr, 16 * ng, kq, ng & 1);
    wipa::cp_async_wait<0>();  // A tile t landed
    __syncthreads();           // tile t complete; tile t - 1 no longer read
    if (t + 1 < nt) {
      const int k1 = (t + 1) * kKT;
      load_a(st ^ 1, k1);
      load_w_patch(wr, wq, k1 + 4 * kq, k, n0 + 16 * ng, n, vec);
    }
    wipa::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wipa::ldmatrix_x4(a[i], wipa::ldsm_rowcol<64>(a_s, 64 * wm + 16 * i, 16 * ks, lane));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        wipa::ldmatrix_x4(b[p], wipa::ldsm_nk<64>(b_s, 32 * wn + 16 * p, 16 * ks, lane));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8_16832(acc[i][j], a[i], b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
    }
  }

  // fragment c of n8 tile j: row g (c < 2) or g + 8, column 2 (l % 4) + c % 2
  const int g = lane >> 2;
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wm + 16 * i + g + 8 * h;
      if (row >= m) continue;
      const float sx = xs[row];
      float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 32 * wn + 8 * j + cq;
        const float v0 = static_cast<float>(acc[i][j][2 * h]) * sx;
        const float v1 = static_cast<float>(acc[i][j][2 * h + 1]) * sx;
        if (vec && col + 1 < n) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0 * ws[col], v1 * ws[col + 1]);
        } else {
          if (col < n) orow[col] = v0 * ws[col];
          if (col + 1 < n) orow[col + 1] = v1 * ws[col + 1];
        }
      }
    }
  }
}

// -- K6, small M: one launch, split K over a thread-block cluster ------------

constexpr int kSN = 32;         // output columns a block
constexpr int kSThreads = 128;  // 4 warps, an n8 tile each
constexpr int kSRows = 64;      // rows at most (4 m16 tiles)
constexpr int kMaxSplit = 8;    // blocks a cluster (the portable maximum)

// grid (ceil(n / kSN), splits), cluster (1, splits, 1): block y owns
// codes [y * slice, min(k, (y + 1) * slice)) of every row
template <typename T>
__global__ void __launch_bounds__(kSThreads)
int8_gemm_small(const T* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ ws, float* __restrict__ out, int m,
                int k, int n, int slice, int vec) {
  namespace cg = cooperative_groups;
  __shared__ __align__(128) uint8_t a_tile[kSRows * kKT];
  __shared__ __align__(128) uint8_t b_tile[kSN * kKT];
  __shared__ float row_max[kSRows];
  __shared__ float row_scale[kSRows];
  __shared__ int part[kSRows * kSN];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kSN;
  const int k_lo = min(k, rank * slice);
  const int k_hi = min(k, k_lo + slice);
  const int mt = (m + 15) >> 4;
  // the weight loaders: 32 k-quads x 2 column groups. The first chunk's
  // patch is requested before anything waits, so its trip to device memory
  // overlaps the row pass and the cluster barrier.
  const bool loader = tid < kSN / 16 * 32;
  const int kq = tid & 31, ng = tid >> 5;
  uint32_t wr[4][4];
  if (loader) load_w_patch(wr, wq, k_lo + 4 * kq, k_hi, n0 + 16 * ng, n, vec);

  // 1. each row's maximum over this slice, then over the cluster's slices
  for (int r = warp; r < m; r += kSThreads / 32) {
    const T* xr = x + static_cast<size_t>(r) * k;
    float amax = 0.f;
    for (int c = k_lo + 4 * lane; c < k_hi; c += 128) amax = amax4(amax, load4(xr + c));
    amax = warp_max(amax);
    if (lane == 0) row_max[r] = amax;
  }
  cluster.sync();
  for (int r = tid; r < m; r += kSThreads) {
    float amax = 0.f;
    for (int q = 0; q < splits; ++q) amax = fmaxf(amax, *cluster.map_shared_rank(row_max + r, q));
    row_scale[r] = fmaxf(amax, 1e-6f) / 127.0f;
  }
  __syncthreads();

  // 2. the slice in 128-code chunks: x quantized into A, weights into B
  const uint32_t a_s = wipa::smem_addr(a_tile);
  const uint32_t b_s = wipa::smem_addr(b_tile);
  int acc[4][4] = {};  // [m16 tile][fragment], this warp's n8 tile
  for (int c0 = k_lo; c0 < k_hi; c0 += kKT) {
    for (int r = warp; r < 16 * mt; r += kSThreads / 32) {
      const int c = c0 + 4 * lane;
      const uint32_t word = (r < m && c < k_hi)
          ? quantize4(load4(x + static_cast<size_t>(r) * k + c), row_scale[r]) : 0u;
      st_shared_u32(a_s + tile_off(r, 4 * lane), word);
    }
    if (loader) {  // this chunk's patch in, the next one's requested
      store_w_patch(b_s, wr, 16 * ng, kq, ng & 1);
      if (c0 + kKT < k_hi) {
        load_w_patch(wr, wq, c0 + kKT + 4 * kq, k_hi, n0 + 16 * ng, n, vec);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kKT / 64; ++kp) {  // two k32 steps a pass
      uint32_t b[4];  // b0, b1 of step 2 kp, then of step 2 kp + 1
      wipa::ldmatrix_x4(b, b_s + tile_off(8 * warp + (lane & 7), 64 * kp + 16 * (lane >> 3)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[4];
            wipa::ldmatrix_x4(a, wipa::ldsm_rowcol<64>(a_s, 16 * i, 32 * kp + 16 * h, lane));
            mma_s8_16832(acc[i], a, b[2 * h], b[2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. partial sums to shared memory; block q adds rows q, q + splits, ...
  const int g = lane >> 2;
  const int col = 8 * warp + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < mt) {
      part[(16 * i + g) * kSN + col] = acc[i][0];
      part[(16 * i + g) * kSN + col + 1] = acc[i][1];
      part[(16 * i + g + 8) * kSN + col] = acc[i][2];
      part[(16 * i + g + 8) * kSN + col + 1] = acc[i][3];
    }
  }
  cluster.sync();
  const int c = n0 + lane;
  for (int r = rank + splits * warp; r < m; r += splits * (kSThreads / 32)) {
    int sum = 0;
    for (int q = 0; q < splits; ++q) sum += cluster.map_shared_rank(part, q)[r * kSN + lane];
    if (c < n) out[static_cast<size_t>(r) * n + c] = static_cast<float>(sum) * row_scale[r] * ws[c];
  }
  cluster.sync();  // no block leaves while another reads its shared memory
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

// -- K7, small M: one launch, split K over a thread-block cluster ------------

constexpr int kQN = 32;     // output columns a block: eight quads
constexpr int kQRows = 16;  // output rows a block
constexpr int kQThreads = 128;  // threads a block
constexpr int kInt4SmemMax = 200 * 1024;  // a block's staged slice, in bytes

// two consecutive x features from shared memory, as f32
__device__ __forceinline__ float2 load_x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// The eight 4-bit codes of a word of four packed bytes (byte b: column b,
// its low nibble row 2r, its high row 2r + 1), sign-extended, as exact
// floats without an int-to-float conversion (a quarter of the FMA rate):
// code + 8 becomes the low mantissa byte of 2^23, and 2^23 + 8 is taken off.
__device__ __forceinline__ void nibbles_f32(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  constexpr float kBias = 8388616.f;  // 2^23 + 8
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    lo[b] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540 + b)) - kBias;
    hi[b] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540 + b)) - kBias;
  }
}

// Dynamic shared memory of a block over `slice` packed rows:
// the scales' group rows (at most n_groups), x (16 rows of 2 * slice
// features), the packed weights (slice rows of 32 bytes); at least the
// warps' partial sums (2 KB a warp), which reuse it.
__host__ __device__ inline size_t int4_small_smem(int slice, int n_groups,
                                                  int x_bytes) {
  const size_t staged = static_cast<size_t>(n_groups) * kQN * sizeof(float) +
                        static_cast<size_t>(kQRows) * 2 * slice * x_bytes +
                        static_cast<size_t>(slice) * kQN;
  const size_t red = static_cast<size_t>(kQThreads / 32) * kQRows * kQN * sizeof(float);
  return staged > red ? staged : red;
}

// grid (splits, ceil(n / 32), ceil(m / 16)), cluster (splits, 1, 1): block
// x owns packed rows [x * slice, min(k / 2, (x + 1) * slice)). xv, wv, sv:
// x, the packed weights and the scales may be copied 16 bytes at a time.
// 8 column quads x 16 groups of packed rows.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
int4_matmul_split_k(const T* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int m, int k, int n, int rows_per_group, int slice,
                    int n_groups_max, int xv, int wv, int sv) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem[];
  // rank 0's: every block's partial sums, published by one cluster barrier
  __shared__ __align__(16) float gather[kMaxSplit][kQRows * kQN];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int n_half = k / 2;
  const int r_lo = min(n_half, rank * slice);
  const int rows = min(n_half, r_lo + slice) - r_lo;
  const int n0 = blockIdx.y * kQN;
  const int m0 = blockIdx.z * kQRows;
  const int g_lo = r_lo / rows_per_group;
  const int n_groups = rows ? (r_lo + rows - 1) / rows_per_group - g_lo + 1 : 0;
  const int xw = 2 * slice;  // x features a staged row
  constexpr int NT = kQThreads;
  constexpr int kGroups = NT / (kQN / 4);  // packed rows r, r + kGroups, ...

  float* sc_s = reinterpret_cast<float*>(smem);
  T* x_s = reinterpret_cast<T*>(sc_s + n_groups_max * kQN);
  uint8_t* w_s = reinterpret_cast<uint8_t*>(x_s + kQRows * xw);

  // 1. the slice into shared memory: scales, x rows, packed weights
  if (sv) {
    for (int i = tid; i < n_groups * (kQN / 4); i += NT) {
      const int g = i >> 3, c = n0 + 4 * (i & 7);
      const bool in = c < n;
      wipa::cp_async16(wipa::smem_addr(sc_s + 4 * i),
                       ws + (in ? static_cast<size_t>(g_lo + g) * n + c : 0), in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < n_groups * kQN; i += NT) {
      const int g = i / kQN, c = n0 + i % kQN;
      sc_s[i] = c < n ? ws[static_cast<size_t>(g_lo + g) * n + c] : 0.f;
    }
  }
  constexpr int kPerChunk = 16 / sizeof(T);  // x features a 16-byte copy
  if (xv) {
    const int per_row = xw / kPerChunk;
    for (int i = tid; i < kQRows * per_row; i += NT) {
      const int r = i / per_row, f = (i - r * per_row) * kPerChunk;
      const int valid = m0 + r < m ? max(0, min(kPerChunk, 2 * rows - f)) : 0;
      const T* src = valid ? x + static_cast<size_t>(m0 + r) * k + 2 * r_lo + f : x;
      wipa::cp_async16(wipa::smem_addr(x_s + r * xw + f), src,
                       valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = tid; i < kQRows * 2 * rows; i += NT) {
      const int r = i / (2 * rows), f = i - r * 2 * rows;
      x_s[r * xw + f] = m0 + r < m ? x[static_cast<size_t>(m0 + r) * k + 2 * r_lo + f]
                                   : zero_of<T>();
    }
  }
  if (wv) {
    for (int i = tid; i < rows * 2; i += NT) {
      const int r = i >> 1, c = n0 + 16 * (i & 1);
      const bool in = c < n;
      wipa::cp_async16(wipa::smem_addr(w_s + 16 * i),
                       wp + (in ? static_cast<size_t>(r_lo + r) * n + c : 0), in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * kQN; i += NT) {
      const int r = i / kQN, c = n0 + i % kQN;
      w_s[i] = c < n ? static_cast<uint8_t>(wp[static_cast<size_t>(r_lo + r) * n + c]) : 0;
    }
  }
  wipa::cp_async_commit();
  wipa::cp_async_wait<0>();
  __syncthreads();

  // 2. thread (quad q, group j): columns 4q..4q+3 of packed rows j, j + kGroups, ...
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qd = lane & 7;
  const int j = (lane >> 3) + 4 * warp;
  float acc[kQRows][4];
#pragma unroll
  for (int i = 0; i < kQRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int r = j; r < rows; r += kGroups) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(w_s + r * kQN + 4 * qd);
    const int g = (r_lo + r) / rows_per_group - g_lo;
    const float4 s = *reinterpret_cast<const float4*>(sc_s + g * kQN + 4 * qd);
    float lo[4], hi[4];
    nibbles_f32(word, lo, hi);
    const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // code * scale in f32, as the plain version
      lo[c] *= sc[c];
      hi[c] *= sc[c];
    }
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
      const float2 xe = load_x2(x_s + i * xw + 2 * r);  // features 2r, 2r + 1
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(xe.x, lo[c], acc[i][c]);
        acc[i][c] = fmaf(xe.y, hi[c], acc[i][c]);
      }
    }
  }

  // 3. the block's sum: over a warp's four groups by shuffles, then over
  // the four warps in shared memory (the staging area, no longer read)
#pragma unroll
  for (int i = 0; i < kQRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 8);
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
    }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][row][column]
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
      reinterpret_cast<float4*>(red + (warp * kQRows + i) * kQN)[qd] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  // the block's sum into rank 0's shared memory, four floats a store
  float4* slot = reinterpret_cast<float4*>(
      cluster.map_shared_rank(&gather[0][0], 0) + rank * kQRows * kQN);
  for (int e = tid; e < kQRows * kQN / 4; e += NT) {
    float4 v = reinterpret_cast<const float4*>(red)[e];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) {
      const float4 u = reinterpret_cast<const float4*>(red + w * kQRows * kQN)[e];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    slot[e] = v;
  }

  // 4. the cluster's sum in rank 0, in rank order; the other blocks leave,
  // as nothing reads their shared memory
  cluster.sync();
  if (rank == 0) {
    for (int e = tid; e < kQRows * kQN; e += NT) {
      const int i = e / kQN, col = n0 + e % kQN;
      float v = gather[0][e];
      for (int q = 1; q < splits; ++q) v += gather[q][e];
      if (m0 + i < m && col < n) out[static_cast<size_t>(m0 + i) * n + col] = v;
    }
  }
}

template <typename T>
cudaError_t launch_int4_small(cudaLaunchConfig_t& cfg, const void* x,
                              const int8_t* wp, const float* ws, float* out, int m,
                              int k, int n, int rows_per_group, int slice,
                              int n_groups_max, int xv, int wv, int sv) {
  auto kernel = int4_matmul_split_k<T>;
  static bool attr_set = false;  // once for each instance
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kInt4SmemMax);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), wp, ws, out, m, k, n,
                            rows_per_group, slice, n_groups_max, xv, wv, sv);
}

}  // namespace

// K6, large M. x: (m, k) f32 or bf16 (is_bf16), 16-byte aligned; w_codes:
// (k, n) int8; w_scale: (n,) f32; out: (m, n) f32; x_codes: (m, ldq) int8
// and x_scale: (m,) f32 scratch, ldq >= k a multiple of 16. k % 4 == 0.
// Two launches (the row pass, the product). Returns cudaGetLastError().
extern "C" int wipa_int8_matmul(const void* x, const void* w_codes,
                                const void* w_scale, void* out, void* x_codes,
                                void* x_scale, int m, int k, int n, int ldq,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0 || k <= 0 || k % 4 || ldq < k || ldq % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || m > 65535 * kTM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (m + kRowWarps - 1) / kRowWarps;
  if (is_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<row_blocks, kRowWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x_codes),
        static_cast<float*>(x_scale), m, k, ldq);
  } else {
    quantize_rows_kernel<float><<<row_blocks, kRowWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(x_codes),
        static_cast<float*>(x_scale), m, k, ldq);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(int8_gemm_tiled,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(w_codes) % 16 == 0;
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  int8_gemm_tiled<<<grid, kTThreads, kTSmem, s>>>(
      static_cast<const int8_t*>(x_codes), ldq, static_cast<const float*>(x_scale),
      static_cast<const int8_t*>(w_codes), static_cast<const float*>(w_scale),
      static_cast<float*>(out), m, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// K6, small M: as above with m <= 64 and no scratch, in one launch of
// `splits` (1..8) K slices of `slice` codes each (a multiple of 32,
// splits * slice >= k). Returns cudaGetLastError().
extern "C" int wipa_int8_matmul_small(const void* x, const void* w_codes,
                                      const void* w_scale, void* out, int m,
                                      int k, int n, int splits, int slice,
                                      int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || m > kSRows || n <= 0 || k <= 0 || k % 4 || splits < 1 ||
      splits > kMaxSplit || slice <= 0 || slice % 32 ||
      static_cast<long long>(splits) * slice < k ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(w_codes) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kSN - 1) / kSN, splits);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int8_t* wc = static_cast<const int8_t*>(w_codes);
  const float* wsc = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    err = cudaLaunchKernelEx(&cfg, int8_gemm_small<__nv_bfloat16>,
                             static_cast<const __nv_bfloat16*>(x), wc, wsc, o,
                             m, k, n, slice, vec);
  } else {
    err = cudaLaunchKernelEx(&cfg, int8_gemm_small<float>,
                             static_cast<const float*>(x), wc, wsc, o, m, k, n,
                             slice, vec);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7, larger M. x: (m, k) f32 or bf16 (is_bf16); w_packed: (k/2, n) int8;
// w_scale: (k/2 / rows_per_group, n) f32; out: (m, n) f32. k even, (k/2) %
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

// K7, small M: as above with m <= 64, in one launch of `splits` (1..8) K
// slices of `slice` packed rows each (a multiple of 16, splits * slice >=
// k / 2 > (splits - 1) * slice). Returns cudaGetLastError().
extern "C" int wipa_int4_matmul_small(const void* x, const void* w_packed,
                                      const void* w_scale, void* out, int m,
                                      int k, int n, int rows_per_group,
                                      int splits, int slice, int is_bf16,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_half = k / 2;
  if (m <= 0 || m > 4 * kQRows || n <= 0 || k <= 0 || k % 2 ||
      rows_per_group <= 0 || n_half % rows_per_group || splits < 1 ||
      splits > kMaxSplit || slice <= 0 || slice % 16 ||
      static_cast<long long>(splits) * slice < n_half ||
      static_cast<long long>(splits - 1) * slice >= n_half) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int x_bytes = is_bf16 ? 2 : 4;
  const int groups = n_half / rows_per_group;
  const int n_groups_max = (slice - 1) / rows_per_group + 2 < groups
                               ? (slice - 1) / rows_per_group + 2 : groups;
  const size_t smem = int4_small_smem(slice, n_groups_max, x_bytes);
  if (smem > kInt4SmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int xv = aligned(x) && (static_cast<long long>(k) * x_bytes) % 16 == 0;
  const int wv = aligned(w_packed) && n % 16 == 0;
  const int sv = aligned(w_scale) && n % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + kQN - 1) / kQN, (m + kQRows - 1) / kQRows);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int8_t* wc = static_cast<const int8_t*>(w_packed);
  const float* wsc = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  err = is_bf16 ? launch_int4_small<__nv_bfloat16>(cfg, x, wc, wsc, o, m, k, n,
                                                   rows_per_group, slice, n_groups_max,
                                                   xv, wv, sv)
                : launch_int4_small<float>(cfg, x, wc, wsc, o, m, k, n, rows_per_group,
                                           slice, n_groups_max, xv, wv, sv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
