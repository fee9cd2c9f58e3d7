// Unmasked attention backward (encoder self-attention, training) for
// Hopper (sm_90a): the K5 kernel.
//
// Replaces: whisper_ipa_tpu/ops/attention.py, _flash_attention_bwd_impl
// (pallas_call :216, body _attn_bwd_kernel :85).
//
// Given q, k, v (B*H, T, Dh), the forward output out and its per-row
// log-sum-exp lse (written by the K2 forward, attention.cu), and the
// output gradient g, computes
//
//   P  = exp(scale * q k^T - lse)          (recomputed, never stored)
//   dV = P^T g
//   dP = g v^T,  delta = rowsum(g . out) = rowsum(P . dP)
//   dS = P . (dP - delta)
//   dQ = scale * dS k,   dK = dS^T (scale q)
//
// with every sum in fp32, for bf16 or fp32 inputs and outputs, Dh in
// {32, 64}.
//
// What bounds it on the H100: on-chip work. At whisper-small's encoder
// (B*H = 144, T = 1500, Dh = 64) the function needs ~10 T^2 Dh per head
// (~207 GFLOP, 0.21 ms at the tensor cores' 989 TFLOP/s) but moves only
// ~190 MB, so it sits far above the memory roofline; the (T, T)
// probabilities must stay on chip. With the recomputation this design
// does 14 T^2 Dh per head and 2 T^2 exponentials.
//
// Why not the TPU design: the TPU kernel holds one head's whole K/V in
// VMEM (bf16 K+V at T = 1500 is 384 KB, more than a block's 227 KB of
// shared memory) and sums dK/dV across q blocks in an output that stays
// resident across grid revisits (blocks here run in parallel, in no
// order). So the work is split into three launches with no atomics, and
// the result is deterministic (training resumes bit for bit):
//
//   1. delta: one warp per query row, rowsum(g . out) in fp32.
//   2. dK/dV: one block per (b*h, 64-key tile). It keeps its K/V tile and
//      its dK/dV accumulators on chip and loops over every 64-query tile:
//      S and dP for the (64, 64) pair, P from the saved lse, dS, then
//      dV += P^T G and dK += dS^T Q.
//   3. dQ: one block per (b*h, 64-query tile), looping over the key
//      tiles: S, dP, P, dS again, then dQ += dS K.
//
// bf16 design (mma.sync m16n8k16, fp32 sums, four warps a block): tiles
// arrive by 16-byte cp.async in a two-stage ring (the next query or key
// tile in flight while this one is used), swizzled as attention_tiles.cuh
// sets out so that ldmatrix and ldmatrix.trans read without bank
// conflicts. Each warp owns 16 rows of its block's tile.
//   dK/dV: warp w owns keys 16w..16w+15 and works in the transposed
//     orientation: S^T = K Q^T and dP^T = V dO^T (Q and dO through plain
//     ldmatrix), so P^T = exp2(log2(e) S^T - lse log2(e)) and
//     dS^T = P^T (dP^T - delta) come out in the accumulator layout, which
//     for 16-bit types is the A-fragment layout: rounded to bf16 they are
//     the A operands of dV += P^T dO and dK += dS^T Q (dO and Q through
//     ldmatrix.trans). lse and delta of the query tile are staged in shared
//     memory beside it. No P or dS goes through shared memory.
//   dQ: warp w owns queries 16w..16w+15, its Q and dO rows held as A
//     fragments in registers; per key tile S = Q K^T and dP = dO V^T (K, V
//     through ldmatrix), P and dS in registers, then dQ += dS K (K through
//     ldmatrix.trans).
// The exponentials are ex2.approx.ftz, as in the forward
// (attention_tiles.cuh). Each Q tile is multiplied by the scale and rounded
// to bf16 in shared memory once it lands, so S and dK = dS^T (scale q) use
// the scaled q in q's dtype; P and dS are rounded to bf16 before their
// products; dQ is multiplied by the scale in fp32 at the end: all as the
// TPU kernel and attention_backward_plain do. Ragged tails: query rows
// past Tq and key rows past Tk arrive zero-filled by the copies and the
// staged lse and delta of query rows past Tq are 0, so every term they add
// is an exact product with a zero row, and their outputs are not written.
// The one mask is in the dQ kernel's last key tile: there a key past Tk
// has P = exp(-lse), which a row of very negative logits would overflow,
// and the dS it makes is summed over keys into live rows of dQ.
//
// fp32 keeps the CUDA-core bodies (the tensor cores have no full-fp32
// product, and TF32 would miss the fp32 bound): 256 threads in a 16 x 16
// grid; a thread owns a 4 x 4 micro-tile of each (64, 64) product (rows
// ty + 16a, columns tx + 16b) and a 4 x (Dh / 16) micro-tile of each
// (64, Dh) accumulator. Tiles sit in shared memory as fp32 with rows
// padded by one word, so the threads of a warp read distinct banks. Key
// rows past Tk and query rows past Tq load as zeros and their P and dS are
// set to 0. The scale is folded into q on load and multiplied into dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kTile = 64;      // queries and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kTile + 1; // padded row of a (64, 64) fp32 tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 1. delta = rowsum(out . g) in fp32, one warp a row (both paths)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ g,
                      float* __restrict__ delta, int rows) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= static_cast<size_t>(rows)) return;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) {
    acc = fmaf(to_f32(out[row * DH + d]), to_f32(g[row * DH + d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// -- fp32: CUDA cores -------------------------------------------------------

// rows [row0, row0 + 64) of a (n, DH) matrix into a padded fp32 tile,
// times mul; rows at or past n load as zeros
template <int DH>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n, float mul) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const int row = row0 + r;
    dst[r * (DH + 1) + d] =
        row < n ? src[static_cast<size_t>(row) * DH + d] * mul : 0.0f;
  }
}

// S = Qs K^T and dP = G V^T for the thread's 4 x 4 micro-tile
// (query rows ty + 16a, key columns tx + 16b)
template <int DH>
__device__ __forceinline__ void scores(const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       int ty, int tx, float s[4][4],
                                       float dp[4][4]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.0f;
      dp[a][b] = 0.0f;
    }
  }
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = qs[(ty + 16 * a) * LD + d];
      gv[a] = gs[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kv[b] = ks[(tx + 16 * b) * LD + d];
      vv[b] = vs[(tx + 16 * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(gv[a], vv[b], dp[a][b]);
      }
    }
  }
}

template <int DH>
constexpr int dkdv_smem_bytes() {
  return (4 * kTile * (DH + 1) + 2 * kTile * kLP + 2 * kTile) *
         static_cast<int>(sizeof(float));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, float scale) {
  constexpr int LD = DH + 1;
  constexpr int DB = DH / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* gs = qs + kTile * LD;
  float* ps = gs + kTile * LD;
  float* dss = ps + kTile * kLP;
  float* lse_s = dss + kTile * kLP;
  float* delta_s = lse_s + kTile;

  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + bh * tq * DH;
  const float* gb = g + bh * tq * DH;

  load_tile<DH>(ks, k + bh * tk * DH, k0, tk, 1.0f);
  load_tile<DH>(vs, v + bh * tk * DH, k0, tk, 1.0f);

  // key rows ty + 16a of the tile, head dims tx + 16b
  float dk_acc[4][DB];
  float dv_acc[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < DB; ++b) {
      dk_acc[a][b] = 0.0f;
      dv_acc[a][b] = 0.0f;
    }
  }

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    __syncthreads();  // the previous q tile is fully consumed
    load_tile<DH>(qs, qb, q0, tq, scale);
    load_tile<DH>(gs, gb, q0, tq, 1.0f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < tq ? lse[bh * tq + row] : 0.0f;
      delta_s[threadIdx.x] = row < tq ? delta[bh * tq + row] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DH>(qs, gs, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const bool row_ok = q0 + r < tq;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b;
        const float p =
            (row_ok && k0 + c < tk) ? expf(s[a][b] - lse_s[r]) : 0.0f;
        ps[r * kLP + c] = p;
        dss[r * kLP + c] = p * (dp[a][b] - delta_s[r]);
      }
    }
    __syncthreads();

    // dV[c][d] += sum_r P[r][c] G[r][d];  dK[c][d] += sum_r dS[r][c] Qs[r][d]
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], gv[DB], qv[DB];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = ps[r * kLP + ty + 16 * a];
        dsv[a] = dss[r * kLP + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < DB; ++b) {
        gv[b] = gs[r * LD + tx + 16 * b];
        qv[b] = qs[r * LD + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < DB; ++b) {
          dv_acc[a][b] = fmaf(pv[a], gv[b], dv_acc[a][b]);
          dk_acc[a][b] = fmaf(dsv[a], qv[b], dk_acc[a][b]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= tk) continue;
    const size_t base = (bh * tk + key) * DH;
#pragma unroll
    for (int b = 0; b < DB; ++b) {
      dk[base + tx + 16 * b] = (dk_acc[a][b]);
      dv[base + tx + 16 * b] = (dv_acc[a][b]);
    }
  }
}

template <int DH>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (DH + 1) + kTile * kLP + 2 * kTile) *
         static_cast<int>(sizeof(float));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int tq, int tk, float scale) {
  constexpr int LD = DH + 1;
  constexpr int DB = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + kTile * LD;
  float* ks = gs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;
  float* lse_s = dss + kTile * kLP;
  float* delta_s = lse_s + kTile;

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* kb = k + bh * tk * DH;
  const float* vb = v + bh * tk * DH;

  load_tile<DH>(qs, q + bh * tq * DH, q0, tq, scale);
  load_tile<DH>(gs, g + bh * tq * DH, q0, tq, 1.0f);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < tq ? lse[bh * tq + row] : 0.0f;
    delta_s[threadIdx.x] = row < tq ? delta[bh * tq + row] : 0.0f;
  }

  // query rows ty + 16a of the tile, head dims tx + 16b
  float dq_acc[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < DB; ++b) dq_acc[a][b] = 0.0f;
  }

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    __syncthreads();  // the previous key tile is fully consumed
    load_tile<DH>(ks, kb, k0, tk, 1.0f);
    load_tile<DH>(vs, vb, k0, tk, 1.0f);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DH>(qs, gs, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const bool row_ok = q0 + r < tq;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b;
        const float p =
            (row_ok && k0 + c < tk) ? expf(s[a][b] - lse_s[r]) : 0.0f;
        dss[r * kLP + c] = p * (dp[a][b] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ[r][d] += sum_c dS[r][c] K[c][d]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[DB];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dss[(ty + 16 * a) * kLP + c];
#pragma unroll
      for (int b = 0; b < DB; ++b) kv[b] = ks[c * LD + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < DB; ++b) {
          dq_acc[a][b] = fmaf(dsv[a], kv[b], dq_acc[a][b]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= tq) continue;
    const size_t base = (bh * tq + row) * DH;
#pragma unroll
    for (int b = 0; b < DB; ++b) {
      dq[base + tx + 16 * b] = (dq_acc[a][b] * scale);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                   const void* out, const void* g, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int bh, int tq,
                   int tk, float scale, cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);

  const int rows = bh * tq;
  const int rows_per_block = kThreads / 32;
  attn_bwd_delta_kernel<float, DH>
      <<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
          static_cast<const float*>(out), gt, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<DH>
      <<<dim3((tk + kTile - 1) / kTile, bh), kThreads, dkdv_bytes, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), tq, tk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = dq_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<DH>
      <<<dim3((tq + kTile - 1) / kTile, bh), kThreads, dq_bytes, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), tq, tk, scale);
  return cudaGetLastError();
}

// -- bf16: mma.sync ---------------------------------------------------------

using bf16 = __nv_bfloat16;
using wipa::Tile;
using wipa::kTileRows;

constexpr int kMmaThreads = 128;  // four warps, 16 tile rows each

template <int DH>
constexpr int dkdv_mma_smem_bytes() {
  // K, V, two Q and two dO stages; two stages of lse and delta; alignment
  return 6 * Tile<DH>::kBytes + 4 * kTileRows * static_cast<int>(sizeof(float)) +
         1024;
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int tq, int tk, float scale) {
  constexpr int TB = Tile<DH>::kBytes;
  constexpr int NB = DH / 8;  // 8-column blocks of a (16, DH) accumulator
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;
  const uint32_t vs = ks + TB;
  const uint32_t qs = ks + 2 * TB;  // stages 0, 1
  const uint32_t gs = ks + 4 * TB;  // stages 0, 1
  uint8_t* const qs_ptr = smem_raw + (qs - raw);
  float* const lse_s = reinterpret_cast<float*>(smem_raw + (ks - raw) + 6 * TB);
  float* const delta_s = lse_s + 2 * kTileRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kTileRows;
  const bf16* qb = q + bh * tq * DH;
  const bf16* gb = g + bh * tq * DH;
  const float* lb = lse + bh * tq;
  const float* db = delta + bh * tq;
  const float c = wipa::kLog2e;  // S^T = k (scale q)^T: the scale is in Q
  const int nq = (tq + kTileRows - 1) / kTileRows;

  // lse (in log2 units) and delta of a query tile; 0 past Tq
  auto stage_rows = [&](int st, int row0) {
    if (tid < kTileRows) {
      const int row = row0 + tid;
      lse_s[st * kTileRows + tid] = row < tq ? lb[row] * wipa::kLog2e : 0.0f;
      delta_s[st * kTileRows + tid] = row < tq ? db[row] : 0.0f;
    }
  };

  wipa::load_tile_async<DH, kMmaThreads>(ks, k + bh * tk * DH, DH, k0, tk, tid);
  wipa::load_tile_async<DH, kMmaThreads>(vs, v + bh * tk * DH, DH, k0, tk, tid);
  wipa::load_tile_async<DH, kMmaThreads>(qs, qb, DH, 0, tq, tid);
  wipa::load_tile_async<DH, kMmaThreads>(gs, gb, DH, 0, tq, tid);
  wipa::cp_async_commit();
  stage_rows(0, 0);

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.0f;
  }

  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    if (it + 1 < nq) {
      const int nx = (it + 1) * kTileRows;
      wipa::load_tile_async<DH, kMmaThreads>(qs + (st ^ 1) * TB, qb, DH, nx, tq, tid);
      wipa::load_tile_async<DH, kMmaThreads>(gs + (st ^ 1) * TB, gb, DH, nx, tq, tid);
      stage_rows(st ^ 1, nx);
    }
    wipa::cp_async_commit();
    wipa::cp_async_wait<1>();
    if (scale != 1.0f) {
      wipa::scale_own_chunks<DH, kMmaThreads>(qs_ptr + st * TB, scale, tid);
    }
    __syncthreads();
    const uint32_t qt = qs + st * TB;
    const uint32_t gt = gs + st * TB;

    // S^T = K Q^T, dP^T = V dO^T: this warp's 16 keys x the 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ka[4], va[4];
      wipa::ldmatrix_x4(ka, wipa::ldsm_rowcol<DH>(ks, 16 * warp, 16 * kk, lane));
      wipa::ldmatrix_x4(va, wipa::ldsm_rowcol<DH>(vs, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        wipa::ldmatrix_x4(b, wipa::ldsm_nk<DH>(qt, 16 * n2, 16 * kk, lane));
        wipa::mma_bf16_16816(s[2 * n2], ka, b[0], b[1]);
        wipa::mma_bf16_16816(s[2 * n2 + 1], ka, b[2], b[3]);
        wipa::ldmatrix_x4(b, wipa::ldsm_nk<DH>(gt, 16 * n2, 16 * kk, lane));
        wipa::mma_bf16_16816(dp[2 * n2], va, b[0], b[1]);
        wipa::mma_bf16_16816(dp[2 * n2 + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 as the A fragments of the four 16-query
    // k-steps; column j block: queries 8j + 2(lane % 4), +1
    uint32_t pa[4][4], dsa[4][4];
    const float* lt = lse_s + st * kTileRows;
    const float* dt = delta_s + st * kTileRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + col);
      const float p0 = wipa::exp2_ftz(fmaf(s[j][0], c, -l2.x));
      const float p1 = wipa::exp2_ftz(fmaf(s[j][1], c, -l2.y));
      const float p2 = wipa::exp2_ftz(fmaf(s[j][2], c, -l2.x));
      const float p3 = wipa::exp2_ftz(fmaf(s[j][3], c, -l2.y));
      pa[j >> 1][2 * (j & 1) + 0] = wipa::pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = wipa::pack_bf16(p2, p3);
      dsa[j >> 1][2 * (j & 1) + 0] =
          wipa::pack_bf16(p0 * (dp[j][0] - d2.x), p1 * (dp[j][1] - d2.y));
      dsa[j >> 1][2 * (j & 1) + 1] =
          wipa::pack_bf16(p2 * (dp[j][2] - d2.x), p3 * (dp[j][3] - d2.y));
    }

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < DH / 16; ++n2) {
        uint32_t b[4];
        wipa::ldmatrix_x4_trans(b, wipa::ldsm_rowcol<DH>(gt, 16 * kk, 16 * n2, lane));
        wipa::mma_bf16_16816(dv_acc[2 * n2], pa[kk], b[0], b[1]);
        wipa::mma_bf16_16816(dv_acc[2 * n2 + 1], pa[kk], b[2], b[3]);
        wipa::ldmatrix_x4_trans(b, wipa::ldsm_rowcol<DH>(qt, 16 * kk, 16 * n2, lane));
        wipa::mma_bf16_16816(dk_acc[2 * n2], dsa[kk], b[0], b[1]);
        wipa::mma_bf16_16816(dk_acc[2 * n2 + 1], dsa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is free for tile it + 2
  }

  const int key = k0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows key, key + 8
      if (key + 8 * i >= tk) continue;
      const size_t off = (bh * tk + key + 8 * i) * DH + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          wipa::pack_bf16(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          wipa::pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int DH>
constexpr int dq_mma_smem_bytes() {
  return 6 * Tile<DH>::kBytes + 1024;  // Q, dO, two K and two V stages
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int tq, int tk, float scale) {
  constexpr int TB = Tile<DH>::kBytes;
  constexpr int NB = DH / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wipa::smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  const uint32_t gs = qs + TB;
  const uint32_t ks = qs + 2 * TB;  // stages 0, 1
  const uint32_t vs = qs + 4 * TB;  // stages 0, 1
  uint8_t* const qs_ptr = smem_raw + (qs - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const bf16* kb = k + bh * tk * DH;
  const bf16* vb = v + bh * tk * DH;
  const float c = wipa::kLog2e;  // S = (scale q) k^T: the scale is in Q
  const int nk = (tk + kTileRows - 1) / kTileRows;

  wipa::load_tile_async<DH, kMmaThreads>(qs, q + bh * tq * DH, DH, q0, tq, tid);
  wipa::load_tile_async<DH, kMmaThreads>(gs, g + bh * tq * DH, DH, q0, tq, tid);
  wipa::load_tile_async<DH, kMmaThreads>(ks, kb, DH, 0, tk, tid);
  wipa::load_tile_async<DH, kMmaThreads>(vs, vb, DH, 0, tk, tid);
  wipa::cp_async_commit();

  // this thread's rows: lo = 16 warp + lane / 4 and lo + 8 of the tile
  const int row_lo = q0 + 16 * warp + (lane >> 2);
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    l2[i] = row < tq ? lse[bh * tq + row] * wipa::kLog2e : 0.0f;
    dl[i] = row < tq ? delta[bh * tq + row] : 0.0f;
  }

  float dq_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[n][i] = 0.0f;
  }
  uint32_t qa[DH / 16][4], ga[DH / 16][4];  // this warp's Q and dO rows

  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {
      const int nx = (it + 1) * kTileRows;
      wipa::load_tile_async<DH, kMmaThreads>(ks + (st ^ 1) * TB, kb, DH, nx, tk, tid);
      wipa::load_tile_async<DH, kMmaThreads>(vs + (st ^ 1) * TB, vb, DH, nx, tk, tid);
    }
    wipa::cp_async_commit();
    wipa::cp_async_wait<1>();
    if (it == 0 && scale != 1.0f) {
      wipa::scale_own_chunks<DH, kMmaThreads>(qs_ptr, scale, tid);
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wipa::ldmatrix_x4(qa[kk], wipa::ldsm_rowcol<DH>(qs, 16 * warp, 16 * kk, lane));
        wipa::ldmatrix_x4(ga[kk], wipa::ldsm_rowcol<DH>(gs, 16 * warp, 16 * kk, lane));
      }
    }
    const uint32_t kt = ks + st * TB;
    const uint32_t vt = vs + st * TB;

    // S = Q K^T, dP = dO V^T: this warp's 16 queries x the 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        wipa::ldmatrix_x4(b, wipa::ldsm_nk<DH>(kt, 16 * n2, 16 * kk, lane));
        wipa::mma_bf16_16816(s[2 * n2], qa[kk], b[0], b[1]);
        wipa::mma_bf16_16816(s[2 * n2 + 1], qa[kk], b[2], b[3]);
        wipa::ldmatrix_x4(b, wipa::ldsm_nk<DH>(vt, 16 * n2, 16 * kk, lane));
        wipa::mma_bf16_16816(dp[2 * n2], ga[kk], b[0], b[1]);
        wipa::mma_bf16_16816(dp[2 * n2 + 1], ga[kk], b[2], b[3]);
      }
    }

    // dS, rounded to bf16 as the A fragments of the four 16-key k-steps
    const int k0 = it * kTileRows;
    const bool tail = k0 + kTileRows > tk;
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p0 = wipa::exp2_ftz(fmaf(s[j][0], c, -l2[0]));
      float p1 = wipa::exp2_ftz(fmaf(s[j][1], c, -l2[0]));
      float p2 = wipa::exp2_ftz(fmaf(s[j][2], c, -l2[1]));
      float p3 = wipa::exp2_ftz(fmaf(s[j][3], c, -l2[1]));
      if (tail) {  // keys past Tk: exp(-lse) may overflow, and inf * 0 = NaN
        const int key = k0 + 8 * j + 2 * (lane & 3);
        if (key >= tk) p0 = p2 = 0.0f;
        if (key + 1 >= tk) p1 = p3 = 0.0f;
      }
      dsa[j >> 1][2 * (j & 1) + 0] =
          wipa::pack_bf16(p0 * (dp[j][0] - dl[0]), p1 * (dp[j][1] - dl[0]));
      dsa[j >> 1][2 * (j & 1) + 1] =
          wipa::pack_bf16(p2 * (dp[j][2] - dl[1]), p3 * (dp[j][3] - dl[1]));
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < DH / 16; ++n2) {
        uint32_t b[4];
        wipa::ldmatrix_x4_trans(b, wipa::ldsm_rowcol<DH>(kt, 16 * kk, 16 * n2, lane));
        wipa::mma_bf16_16816(dq_acc[2 * n2], dsa[kk], b[0], b[1]);
        wipa::mma_bf16_16816(dq_acc[2 * n2 + 1], dsa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is free for tile it + 2
  }

#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows lo, lo + 8
      const int row = row_lo + 8 * i;
      if (row >= tq) continue;
      *reinterpret_cast<uint32_t*>(dq + (bh * tq + row) * DH + col) =
          wipa::pack_bf16(dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* out, const void* g, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int bh,
                       int tq, int tk, float scale, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);

  const int rows = bh * tq;
  const int rows_per_block = kThreads / 32;
  attn_bwd_delta_kernel<bf16, DH>
      <<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
          static_cast<const bf16*>(out), gt, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_mma_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_mma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_mma<DH>
      <<<dim3((tk + kTileRows - 1) / kTileRows, bh), kMmaThreads, dkdv_bytes,
         stream>>>(qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), tq, tk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = dq_mma_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dq_mma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_mma<DH>
      <<<dim3((tq + kTileRows - 1) / kTileRows, bh), kMmaThreads, dq_bytes,
         stream>>>(qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), tq, tk,
                   scale);
  return cudaGetLastError();
}

}  // namespace

// q, out, g, dq: (bh, tq, dh); k, v, dk, dv: (bh, tk, dh); all contiguous,
// bf16 when is_bf16 else fp32, bf16 operands 16-byte aligned; lse: f32
// (bh, tq) from the forward; delta: f32 (bh, tq) scratch; dh in {32, 64};
// tq, tk >= 1. Three launches on `stream` (delta, dK/dV, dQ). Returns the first CUDA error, else
// cudaGetLastError().
extern "C" int wipa_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* out, const void* g,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int tq, int tk,
                                  int dh, int is_bf16, float scale, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tq < 1 || tk < 1 || bh < 1 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dh == 64) {
    err = is_bf16 ? launch_mma<64>(q, k, v, out, g, l, dl, dq, dk, dv, bh, tq,
                                   tk, scale, s)
                  : launch_f32<64>(q, k, v, out, g, l, dl, dq, dk, dv, bh,
                                      tq, tk, scale, s);
  } else if (dh == 32) {
    err = is_bf16 ? launch_mma<32>(q, k, v, out, g, l, dl, dq, dk, dv, bh, tq,
                                   tk, scale, s)
                  : launch_f32<32>(q, k, v, out, g, l, dl, dq, dk, dv, bh,
                                      tq, tk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
