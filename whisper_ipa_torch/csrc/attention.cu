// Unmasked attention forward (encoder self-attention) for Hopper (sm_90a).
//
// Replaces: whisper_ipa_tpu/ops/attention.py, fused_attention forward
// (_fused_attention_impl :443, pallas_call :463, body _attn_kernel :39).
//
// out = softmax(scale * q k^T) v over (B*H, T, Dh), Dh in {32, 64}, with
// logits, softmax and the output accumulated in fp32; the output is divided
// by the row sum once at the end.
//
// What bounds it on the H100: on-chip work, not bytes. At the encoder's
// T=1500, Dh=64 a (b, h) pair reads 0.4 MB of q/k/v in bf16 but does
// 4*T^2*Dh = 576 MFLOP; the TPU kernel held one head's whole K/V in VMEM,
// but K+V in bf16 is ~384 KB here, more than a block's 227 KB of shared
// memory, and the (T, T) probabilities must not reach device memory. At
// batch 16 (192 heads) the products take 0.11 ms at the tensor cores' 989
// TFLOP/s, and the 432 M exponentials about as long on the SFUs (~0.1 ms at
// 16 a clock an SM): both units bound this kernel, so neither may idle.
//
// bf16 design (wgmma, one warpgroup a block): a block of 128 threads owns
// 64 query rows of one (b, h); grid (ceil(Tq / 64), B*H). Its Q tile goes
// once into shared memory; K and V stream through a two-stage ring of
// 64-key tiles, each copy a 16-byte cp.async a thread, the next tile in
// flight while this one is used. Key rows past Tk are zero-filled by the
// copy's source size (the ragged tail: 1500 is no multiple of 64) and
// their logits set to -inf. Tiles use the 128-byte (Dh 64) or 64-byte
// (Dh 32) swizzle of attention_tiles.cuh; ~41 KB (Dh 64) a block, so
// several blocks share an SM and one's softmax overlaps another's products.
//   S = Q K^T: wgmma m64n64k16, both operands from shared memory (K is
//     key-major with Dh contiguous: the K-major B operand), Dh/16 k-steps.
//   The Q tile is multiplied by the scale and rounded to bf16 in shared
//     memory once it lands, as the TPU kernel and the plain version scale
//     q in its own dtype (exact at Dh 64, whose scale is 1/8).
//   Online softmax on the accumulator fragments: a row's 64 logits sit in
//     the four threads of a quad, so the row max takes two shuffles; the
//     running sum stays a per-thread partial until the end. log2(e) is
//     folded into one FMA ahead of the exponential (the scale is already
//     in Q), and the exponential is ex2.approx.ftz: the softmax's ALU work
//     (max, FMA, sum, bf16 packing, the rescale of O) competes with the
//     special-function unit, so exp2f's extra denormal handling costs time.
//   O += P V: P is rounded to bf16 in registers, where the S accumulator
//     layout is already the A-fragment layout of wgmma's register form
//     (m64n{Dh}k16, A from registers); V (Dh contiguous) is an MN-major B,
//     read with the transpose bit.
//   Epilogue: O / l in fp32, rounded to bf16, staged through the Q tile for
//     16-byte stores; lse = m + log(l) when the caller passes a buffer.
// P is rounded to bf16 before the value product and the row sum is taken
// over the unrounded P, as the TPU kernel does (p.astype(v.dtype), fp32
// denominator). Each tile's two products are waited for in turn: issuing
// tile t's S product beside tile t-1's value product, so that the softmax
// runs while the tensor cores work (one warpgroup pipelining itself), was
// slower on the H100: the other blocks on the SM already fill that gap.
//
// fp32 keeps the CUDA-core body (the tensor cores have no full-fp32
// product, and TF32 would miss the fp32 bound): a block of 128 threads
// owns 128 query rows, one a thread, the pre-scaled q row and the fp32
// output row in registers; K/V stream through shared memory in 32-key
// tiles; the products are fp32 FMAs.
//
// Training: when the caller passes an lse buffer, each live row also
// writes its log-sum-exp, m + log(l) over the scaled logits (f32,
// (B*H, T)), the residual the backward kernel (attention_bwd.cu, K5)
// recomputes the probabilities from.
//
// K10, head-merged I/O (wipa_attention_merged_fwd). Replaces:
// whisper_ipa_tpu/ops/attention.py, fused_attention_merged (:308,
// pallas_call :383, body _attn_kernel_merged :252). q, k, v and out are
// (B, T, H*Dh): head h of row t lies at column h*Dh of a row of stride
// H*Dh, so the split/merge copies around K2 disappear. The bodies are K2's,
// addressed through (n_head, row stride): K2 is their n_head = 1 case,
// where (B*H, T, Dh) is a merged layout with one head. Block (query tile,
// b*H + h) reads head h's slices; the arithmetic is K2's in K2's order, so
// K10's output equals K2's on split heads bit for bit. A bf16 head slice
// is 64 or 128 B, whole 16-byte chunks. Bound: K2's (the same operations
// and bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wipa::Tile;
using wipa::kTileRows;

// -- bf16: wgmma ------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup

using wipa::fence_regs;
using wipa::make_desc;
using wipa::wgmma_commit;
using wipa::wgmma_fence;
using wipa::wgmma_wait_all;

#define WIPA_D8(b)                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),      \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WIPA_D8(0), WIPA_D8(8), WIPA_D8(16), WIPA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 16, registers) B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : WIPA_D8(0), WIPA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WIPA_D8

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 64) {
    wgmma_m64n64k16_rs(o, a, db);
  } else {
    wgmma_m64n32k16_rs(o, a, db);
  }
}

template <int DH>
constexpr int wgmma_smem_bytes() {
  return 5 * Tile<DH>::kBytes + 1024;  // Q, two K and two V stages; align
}

// Accumulator layout of m64nNk16 (f32): thread t = 32 w + l holds rows
// 16 w + l / 4 ("lo") and that + 8 ("hi"); register 4 j + 2 i + c is row
// lo (i = 0) or hi (i = 1), column 8 j + 2 (l % 4) + c.
template <int DH>
__global__ void __launch_bounds__(kWgThreads)
attention_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int n_head, int tq, int tk,
                    float scale) {
  constexpr int TB = Tile<DH>::kBytes;
  constexpr int RB = Tile<DH>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;  // Q tile, then the output
  const uint32_t ks = qs + TB;                // K stages 0, 1
  const uint32_t vs = qs + 3 * TB;            // V stages 0, 1
  uint8_t* const qs_ptr = smem_raw + (qs - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t bh = blockIdx.y;
  const size_t b = bh / n_head;
  const size_t h = bh - b * n_head;
  const size_t rs = static_cast<size_t>(n_head) * DH;
  const int q0 = blockIdx.x * kTileRows;
  const bf16* qb = q + b * tq * rs + h * DH;
  const bf16* kb = k + b * tk * rs + h * DH;
  const bf16* vb = v + b * tk * rs + h * DH;
  const int nt = (tk + kTileRows - 1) / kTileRows;

  wipa::load_tile_async<DH, kWgThreads>(qs, qb, rs, q0, tq, tid);
  wipa::load_tile_async<DH, kWgThreads>(ks, kb, rs, 0, tk, tid);
  wipa::load_tile_async<DH, kWgThreads>(vs, vb, rs, 0, tk, tid);
  wipa::cp_async_commit();

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of log2e*s
  float l_lo = 0.0f, l_hi = 0.0f;            // this thread's share of the sum
  const float c = wipa::kLog2e;  // s = (scale q) k: the scale is in Q
  const int col = 2 * (lane & 3);

  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {
      const int nx = (t + 1) * kTileRows;
      wipa::load_tile_async<DH, kWgThreads>(ks + (st ^ 1) * TB, kb, rs, nx, tk, tid);
      wipa::load_tile_async<DH, kWgThreads>(vs + (st ^ 1) * TB, vb, rs, nx, tk, tid);
    }
    wipa::cp_async_commit();
    wipa::cp_async_wait<1>();  // tile t (and Q) landed
    if (t == 0 && scale != 1.0f) {
      wipa::scale_own_chunks<DH, kWgThreads>(qs_ptr, scale, tid);
    }
    wipa::fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wipa::wgmma_m64n64k16_ss<0>(s, make_desc<DH>(qs + 32 * kk),
                                  make_desc<DH>(ks + st * TB + 32 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = t * kTileRows;
    if (k0 + kTileRows > tk) {  // keys past Tk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + col;
        if (key >= tk) s[4 * j + 0] = s[4 * j + 2] = -INFINITY;
        if (key + 1 >= tk) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // every tile has a live key, so the new maxima are finite
    const float mn_lo = fmaxf(m_lo, mx_lo * c);
    const float mn_hi = fmaxf(m_hi, mx_hi * c);
    const float corr_lo = wipa::exp2_ftz(m_lo - mn_lo);  // 0 on the first tile
    const float corr_hi = wipa::exp2_ftz(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    uint32_t pa[4][4];  // P as the A fragments of the four 16-key k-steps
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = wipa::exp2_ftz(fmaf(s[4 * j + 0], c, -mn_lo));
      const float p1 = wipa::exp2_ftz(fmaf(s[4 * j + 1], c, -mn_lo));
      const float p2 = wipa::exp2_ftz(fmaf(s[4 * j + 2], c, -mn_hi));
      const float p3 = wipa::exp2_ftz(fmaf(s[4 * j + 3], c, -mn_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pa[j >> 1][2 * (j & 1) + 0] = wipa::pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = wipa::pack_bf16(p2, p3);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j + 0] *= corr_lo;
      o[4 * j + 1] *= corr_lo;
      o[4 * j + 2] *= corr_hi;
      o[4 * j + 3] *= corr_hi;
    }

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<DH>(o, pa[kk], make_desc<DH>(vs + st * TB + kk * 16 * RB));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // stage st is free for tile t + 2
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.0f / l_lo;
  const float inv_hi = 1.0f / l_hi;
  const int r_lo = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const uint32_t off = (8 * j + col) * 2;
    *reinterpret_cast<uint32_t*>(qs_ptr + wipa::swz<DH>(r_lo * RB + off)) =
        wipa::pack_bf16(o[4 * j + 0] * inv_lo, o[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(qs_ptr + wipa::swz<DH>((r_lo + 8) * RB + off)) =
        wipa::pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    if (q0 + r_lo < tq) lse[bh * tq + q0 + r_lo] = m_lo * wipa::kLn2 + logf(l_lo);
    if (q0 + r_lo + 8 < tq) {
      lse[bh * tq + q0 + r_lo + 8] = m_hi * wipa::kLn2 + logf(l_hi);
    }
  }
  __syncthreads();
  bf16* ob = out + b * tq * rs + h * DH;
  constexpr int kChunks = Tile<DH>::kChunks;
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kWgThreads; ++i) {
    const int cidx = tid + i * kWgThreads;
    const int r = cidx / kChunks;
    const int ch = cidx % kChunks;
    if (q0 + r < tq) {
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + r) * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(qs_ptr + wipa::swz<DH>(r * RB + ch * 16));
    }
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int bh, int n_head, int tq,
                         int tk, float scale, cudaStream_t stream) {
  const dim3 grid((tq + kTileRows - 1) / kTileRows, bh);
  attention_fwd_wgmma<DH><<<grid, kWgThreads, wgmma_smem_bytes<DH>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, n_head, tq,
      tk, scale);
  return cudaGetLastError();
}

// -- fp32: CUDA cores -------------------------------------------------------

constexpr int kRows = 128;  // query rows (= threads) per block
constexpr int kKeys = 32;   // keys per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(kRows)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int n_head, int tq, int tk,
                  float scale) {
  __shared__ __align__(16) float ks[kKeys][DH];
  __shared__ __align__(16) float vs[kKeys][DH];

  // block y = b * n_head + h; rows of every operand have stride n_head*DH
  const size_t bh = blockIdx.y;
  const size_t b = bh / n_head;
  const size_t h = bh - b * n_head;
  const size_t rs = static_cast<size_t>(n_head) * DH;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < tq;
  const float* qb = q + b * tq * rs + h * DH;
  const float* kb = k + b * tk * rs + h * DH;
  const float* vb = v + b * tk * rs + h * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? qb[static_cast<size_t>(row) * rs + d] * scale : 0.0f;
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
      ks[j][d] = in ? kb[static_cast<size_t>(key) * rs + d] : 0.0f;
      vs[j][d] = in ? vb[static_cast<size_t>(key) * rs + d] : 0.0f;
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
    float* o = out + b * tq * rs + h * DH + static_cast<size_t>(row) * rs;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = acc[d] * inv;
    if (lse != nullptr) lse[bh * tq + row] = m + logf(l);
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int n_head, int tq, int tk,
                       float scale, cudaStream_t stream) {
  const dim3 grid((tq + kRows - 1) / kRows, bh);
  attention_fwd_f32<DH><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, n_head, tq,
      tk, scale);
  return cudaGetLastError();
}

// bh = batch * n_head blocks along y; n_head = 1 is K2's split layout.
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* lse, int bh, int n_head, int tq, int tk, int dh,
             int is_bf16, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tq < 1 || tk < 1 || n_head < 1 || bh < 1 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dh == 64) {
    err = is_bf16
        ? launch_wgmma<64>(q, k, v, out, l, bh, n_head, tq, tk, scale, s)
        : launch_f32<64>(q, k, v, out, l, bh, n_head, tq, tk, scale, s);
  } else if (dh == 32) {
    err = is_bf16
        ? launch_wgmma<32>(q, k, v, out, l, bh, n_head, tq, tk, scale, s)
        : launch_f32<32>(q, k, v, out, l, bh, n_head, tq, tk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// q: (bh, tq, dh); k, v: (bh, tk, dh); out: (bh, tq, dh); all contiguous,
// bf16 when is_bf16 else fp32, bf16 operands 16-byte aligned; dh in
// {32, 64}; tq, tk >= 1. lse: null, or an f32 (bh, tq) buffer for the
// rows' log-sum-exp. Returns cudaGetLastError().
extern "C" int wipa_attention_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int bh, int tq, int tk,
                                  int dh, int is_bf16, float scale, int device,
                                  void* stream) {
  return dispatch(q, k, v, out, lse, bh, 1, tq, tk, dh, is_bf16, scale, device,
                  stream);
}

// K10. q, out: (b, tq, n_head * dh); k, v: (b, tk, n_head * dh); all
// contiguous, bf16 when is_bf16 else fp32, bf16 operands 16-byte aligned;
// dh in {32, 64}; tq, tk >= 1. lse: null, or an f32 (b, n_head, tq) buffer
// for the rows' log-sum-exp. Returns cudaGetLastError().
extern "C" int wipa_attention_merged_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int b, int n_head, int tq, int tk,
                                         int dh, int is_bf16, float scale,
                                         int device, void* stream) {
  return dispatch(q, k, v, out, lse, b * n_head, n_head, tq, tk, dh, is_bf16,
                  scale, device, stream);
}
