// Shared device helpers of the bf16 tensor-core kernels (attention.cu:
// K2/K10 forward on wgmma; attention_bwd.cu: K5 backward on mma.sync;
// kv_init.cu: K3's projection on wgmma; quant_matmul.cu: K6's int8 tiles
// through ldmatrix): asynchronous tile loads with a zero-filled ragged
// tail, the shared-memory swizzle both instruction families read, ldmatrix
// and the m16n8k16 product, the wgmma descriptors and fences, and bf16
// packing.
//
// Tile layout: a (64, DH) bf16 tile of rows (queries or keys) with DH
// contiguous, DH in {32, 64}, so a row is 64 or 128 bytes. Byte offset o of
// the unswizzled row-major tile is stored at
//
//   o ^ (((o >> 7) & M) << 4),   M = 7 for 128-byte rows, 3 for 64-byte rows
//
// which is the 128-byte (DH 64) or 64-byte (DH 32) swizzle of Hopper's
// wgmma descriptors (CUTLASS Swizzle<3,4,3> / Swizzle<2,4,3>) when the tile
// starts on a 1024-byte boundary. It also lets the eight rows that one
// ldmatrix (or ldmatrix.trans) 8x8 matrix reads fall in eight distinct
// 16-byte bank groups, so the mma.sync kernels read without conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wipa {

constexpr int kTileRows = 64;  // queries or keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Tile {
  static_assert(DH == 32 || DH == 64, "head dim 32 or 64");
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kBytes = kTileRows * kRowBytes;
  static constexpr int kChunks = DH / 8;  // 16-byte chunks a row
  static constexpr uint32_t kSwizzle = DH == 64 ? 7u : 3u;
};

template <int DH>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & Tile<DH>::kSwizzle) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a bf16 matrix with row stride rs (elements)
// into the swizzled tile at shared address dst, by `threads` threads
// (thread index tid); rows at or past n are zero-filled by the copy itself.
template <int DH, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                size_t rs, int row0, int n,
                                                int tid) {
  constexpr int kPer = kTileRows * Tile<DH>::kChunks / THREADS;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / Tile<DH>::kChunks;
    const int ch = c % Tile<DH>::kChunks;
    const int row = row0 + r;
    const bool in = row < n;
    // a row past n reads nothing; its address stays inside the matrix
    const __nv_bfloat16* p = src + static_cast<size_t>(in ? row : 0) * rs + ch * 8;
    cp_async16(dst + swz<DH>(r * Tile<DH>::kRowBytes + ch * 16), p, in ? 16 : 0);
  }
}

// Multiply the chunks of a tile that this thread copied (load_tile_async's
// mapping, so no barrier is needed after its cp.async wait) by s in fp32
// and round them to bf16: q * scale in q's own dtype, as the plain
// versions and the TPU kernels scale q. Zero-filled rows stay zero.
template <int DH, int THREADS>
__device__ __forceinline__ void scale_own_chunks(uint8_t* tile, float s,
                                                 int tid) {
  constexpr int kPer = kTileRows * Tile<DH>::kChunks / THREADS;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / Tile<DH>::kChunks;
    const int ch = c % Tile<DH>::kChunks;
    uint4* p = reinterpret_cast<uint4*>(tile + swz<DH>(r * Tile<DH>::kRowBytes + ch * 16));
    uint4 v = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * s, f.y * s);
    }
    *p = v;
  }
}

// make the generic-proxy writes of this thread (cp.async, st.shared)
// visible to the async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit alone (ex2.approx.ftz): exp2f also
// scales denormal results, a few more instructions on the ALUs that the
// softmax already keeps busy; a probability below 2^-126 becomes 0, which
// no bf16 product or fp32 row sum here can tell apart
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8. Non-transposed: r[j] holds row l/4, columns 2(l%4), +1 of
// matrix j; transposed: rows 2(l%4), +1 of column l/4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared address (swizzled) of the row a lane gives to ldmatrix x4 for the
// 16 x 16 block at (row0, col0) of a tile: matrix j = lane / 8 covers rows
// row0 + 8 * (j & 1), columns col0 + 8 * (j >> 1). Non-transposed, the four
// registers are the m16n8k16 A fragment of that block. Transposed, on a
// tile whose rows are k and columns n, they are {b0, b1} of n-block col0
// and {b0, b1} of n-block col0 + 8.
template <int DH>
__device__ __forceinline__ uint32_t ldsm_rowcol(uint32_t base, int row0,
                                                int col0, int lane) {
  const int j = lane >> 3;
  const int r = row0 + (lane & 7) + 8 * (j & 1);
  const int c = col0 + 8 * (j >> 1);
  return base + swz<DH>(r * Tile<DH>::kRowBytes + c * 2);
}

// The same for a B operand stored n-major (tile rows are n, columns k):
// matrix j covers rows n0 + 8 * (j >> 1), columns k0 + 8 * (j & 1), so the
// registers are {b0, b1} of n-block n0 and {b0, b1} of n-block n0 + 8.
template <int DH>
__device__ __forceinline__ uint32_t ldsm_nk(uint32_t base, int n0, int k0,
                                            int lane) {
  const int j = lane >> 3;
  const int r = n0 + (lane & 7) + 8 * (j >> 1);
  const int c = k0 + 8 * (j & 1);
  return base + swz<DH>(r * Tile<DH>::kRowBytes + c * 2);
}

// -- wgmma (sm_90a) ----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of these registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled (64, DH) tile (or a k-step
// inside it): 128-byte swizzle for DH 64, 64-byte for DH 32; the stride
// between 8-row groups is 8 rows; the leading offset is unused by these
// layouts (one swizzle atom spans the whole row).
template <int DH>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kLayout = DH == 64 ? 1 : 2;
  constexpr uint64_t kSbo = (8 * Tile<DH>::kRowBytes) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (kSbo << 32) | (kLayout << 62);
}

#define WIPA_D8(b)                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),      \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 64) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared): B is
// K-major, or MN-major (rows k, 64 contiguous n) read with the transpose
// bit when TRANS_B is 1
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : WIPA_D8(0), WIPA_D8(8), WIPA_D8(16), WIPA_D8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 32) (+)= A (64 x 16, shared, K-major) B (16 x 32, shared), B as
// in the n64 form
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : WIPA_D8(0), WIPA_D8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

#undef WIPA_D8

}  // namespace wipa
