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
//   dQ = scale * dS k,   dK = dS^T (scale * q)
//
// with every product and sum in fp32, for bf16 or fp32 inputs and
// outputs, Dh in {32, 64}.
//
// What bounds it on the H100: on-chip work. At whisper-small's encoder
// (B*H = 144, T = 1500, Dh = 64) the function needs ~10 T^2 Dh per head
// (~207 GFLOP) but moves only ~190 MB, so it sits far above the
// memory roofline; the (T, T) probabilities must stay on chip.
//
// Why not the TPU design: the TPU kernel holds one head's whole K/V in
// VMEM (bf16 K+V at T = 1500 is 384 KB, more than a block's 227 KB of
// shared memory) and sums dK/dV across q blocks in an output that stays
// resident across grid revisits (blocks here run in parallel, in no
// order). So the work is split into three launches with no atomics, and
// the result is deterministic:
//
//   1. delta: one warp per query row, rowsum(g . out) in fp32.
//   2. dK/dV: one block per (b*h, 64-key tile). It keeps its K/V tile and
//      its dK/dV accumulators on chip and loops over every 64-query tile:
//      S and dP for the (64, 64) pair, P from the saved lse, dS, then
//      dV += P^T G and dK += dS^T Qs.
//   3. dQ: one block per (b*h, 64-query tile), looping over the key
//      tiles: S, dP, P, dS again, then dQ += dS K.
//
// Each block has 256 threads in a 16 x 16 grid; a thread owns a 4 x 4
// micro-tile of each (64, 64) product (rows ty + 16a, columns tx + 16b)
// and a 4 x (Dh / 16) micro-tile of each (64, Dh) accumulator. Tiles sit
// in shared memory as fp32 with rows padded by one word, so the threads
// of a warp read distinct banks. Ragged tails, as the TPU kernel does:
// key rows past Tk and query rows past Tq load as zeros and their P and
// dS are set to 0, so they contribute nothing; their outputs are not
// written. The scale is folded into q on load and multiplied into dQ.
//
// The products are fp32 FMAs on the CUDA cores (~14 T^2 Dh flops per head
// with the recomputation, against 67 TFLOP/s): simple and exact; a
// tensor-core (wgmma) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;      // queries and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kTile + 1; // padded row of a (64, 64) fp32 tile

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

// rows [row0, row0 + 64) of a (n, DH) matrix into a padded fp32 tile,
// times mul; rows at or past n load as zeros
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n, float mul) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const int row = row0 + r;
    dst[r * (DH + 1) + d] =
        row < n ? to_f32(src[static_cast<size_t>(row) * DH + d]) * mul : 0.0f;
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

template <int DH>
constexpr int dkdv_smem_bytes() {
  return (4 * kTile * (DH + 1) + 2 * kTile * kLP + 2 * kTile) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, float scale) {
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
  const T* qb = q + bh * tq * DH;
  const T* gb = g + bh * tq * DH;

  load_tile<T, DH>(ks, k + bh * tk * DH, k0, tk, 1.0f);
  load_tile<T, DH>(vs, v + bh * tk * DH, k0, tk, 1.0f);

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
    load_tile<T, DH>(qs, qb, q0, tq, scale);
    load_tile<T, DH>(gs, gb, q0, tq, 1.0f);
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
      dk[base + tx + 16 * b] = from_f32<T>(dk_acc[a][b]);
      dv[base + tx + 16 * b] = from_f32<T>(dv_acc[a][b]);
    }
  }
}

template <int DH>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (DH + 1) + kTile * kLP + 2 * kTile) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
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
  const T* kb = k + bh * tk * DH;
  const T* vb = v + bh * tk * DH;

  load_tile<T, DH>(qs, q + bh * tq * DH, q0, tq, scale);
  load_tile<T, DH>(gs, g + bh * tq * DH, q0, tq, 1.0f);
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
    load_tile<T, DH>(ks, kb, k0, tk, 1.0f);
    load_tile<T, DH>(vs, vb, k0, tk, 1.0f);
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
      dq[base + tx + 16 * b] = from_f32<T>(dq_acc[a][b] * scale);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* g, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int bh, int tq,
                   int tk, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);

  const int rows = bh * tq;
  const int rows_per_block = kThreads / 32;
  attn_bwd_delta_kernel<T, DH>
      <<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
          static_cast<const T*>(out), gt, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkdv_bytes = dkdv_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, DH>
      <<<dim3((tk + kTile - 1) / kTile, bh), kThreads, dkdv_bytes, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
          tq, tk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = dq_smem_bytes<DH>();
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, DH>
      <<<dim3((tq + kTile - 1) / kTile, bh), kThreads, dq_bytes, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out, g, dq: (bh, tq, dh); k, v, dk, dv: (bh, tk, dh); all contiguous,
// bf16 when is_bf16 else fp32; lse: f32 (bh, tq) from the forward; delta:
// f32 (bh, tq) scratch; dh in {32, 64}; tq, tk >= 1. Three launches on
// `stream` (delta, dK/dV, dQ). Returns the first CUDA error, else
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
    err = is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, out, g, l, dl, dq, dk,
                                              dv, bh, tq, tk, scale, s)
                  : launch<float, 64>(q, k, v, out, g, l, dl, dq, dk, dv, bh,
                                      tq, tk, scale, s);
  } else if (dh == 32) {
    err = is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, out, g, l, dl, dq, dk,
                                              dv, bh, tq, tk, scale, s)
                  : launch<float, 32>(q, k, v, out, g, l, dl, dq, dk, dv, bh,
                                      tq, tk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
