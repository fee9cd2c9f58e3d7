// Single-query cross-attention over the int8 (K4) and the nibble-packed int4
// (K8) T-minor caches, for Hopper (sm_90a).
//
// K4 replaces: whisper_ipa_tpu/ops/decode_attention.py,
// decode_cross_attention_int8_tminor (:83, pallas_call :112, body _kernel
// :46). K8 replaces: decode_cross_attention_int4_tminor (:188, pallas_call
// :236, body _kernel_int4 :122).
//
// For each (b, h), with q pre-scaled by Dh^-0.5, codes (Dh, T_pad) int8 and
// scales (T_pad,) f32 where scale 0 marks a padded position:
//   logit_t = (q . k_codes[:, t]) * k_scale_t   (-inf where k_scale_t == 0)
//   out     = sum_t exp(logit_t - max) * v_scale_t * v_codes[:, t]
//             / sum_t exp(logit_t - max)
//
// What bounds it on the H100: device-memory bytes. Each decode step of each
// decoder layer reads the whole int8 cache once (2 * B * H * Dh * T_pad
// bytes plus f32 scales, ~40 MB a layer for whisper-small at batch 16) and
// does ~2 FLOPs per byte, far below the ridge. Without this kernel eager
// PyTorch would first write a bf16 copy of the cache, tripling the bytes.
//
// K4's design: one launch, the whole slice in flight. A thread-block
// cluster of up to 8 blocks of 256 threads splits T for each (b, h) (6
// slices of 256 positions at T_pad 1536: 1152 blocks at B * H = 192). A
// block issues all of its slice's K codes and both scale vectors as one
// cp.async group and its V codes as a second, 16 bytes a copy, so the V
// bytes stream while the logits are taken from K in shared memory. The
// codes become floats without int-to-float conversions (byte + 128 as the
// low mantissa byte of 2^23, less 2^23 + 128: exact). The logits, their
// max and row sum stay in f32; the V scales fold into the probabilities;
// each thread then owns one head dimension of p . v_codes over a share of
// the slice. Each block writes its (acc[Dh], max, sum) into the shared
// memory of the cluster's rank 0; one cluster barrier publishes them, the
// other blocks leave, and rank 0 rescales, divides once and writes out. No
// scratch tensor and no second kernel.
//
// The blocks of a wave load together and then compute together, so a
// block's work after its loads lands is on the critical path: what shortened
// it was one cluster barrier instead of two, 256 threads and 256-position
// slices. A persistent, double-buffered form (a cluster walking several
// (b, h)) and cp.async.bulk copies of each row segment were tried on the
// H100 and were slower.
//
// K8 is two passes over half the bytes (flash-decoding): pass 1 gives each
// (split, b*h) block a 128-multiple slice of T and leaves its (max, sum,
// acc) in a scratch tensor; pass 2 merges the slices. Byte t2 of a (b, h,
// d) row holds position 2*t2 in its low nibble and 2*t2+1 in its high, each
// a sign-extended 4-bit code, and the scales keep the natural (B, H, T_pad)
// order. A thread widens one char4 (eight positions) at a time in
// registers, so the logits land in shared memory in position order: the
// max and the row sum are taken over both nibble planes together, and the
// output is the two planes' AV dots summed, divided once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Reduce over a block of NT threads; every thread gets the result.
template <bool kMax, int NT = kThreads>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// -- K4: one launch, T split over a thread-block cluster ----------------------

constexpr int kMaxSplit = 8;    // blocks a cluster (the portable maximum)
constexpr int kMaxSlice = 1024;  // positions a block: its codes fill shared memory
constexpr int kK4Threads = 256;  // threads a block

// Row stride in shared memory of a slice's codes, in bytes: the slice when
// it is an odd number of 16-byte chunks, else one chunk more, so that eight
// consecutive rows' 16-byte reads fall in eight distinct bank groups.
__host__ __device__ constexpr int k4_row_stride(int slice) {
  return (slice / 16) % 2 ? slice : slice + 16;
}

// floats of the scratch that holds the logits' partial sums (DH / 16 groups
// of `slice`), then the value rows' partial sums (one a thread)
template <int DH>
__host__ __device__ constexpr int k4_red_floats(int slice) {
  return (DH / 16) * slice > kK4Threads ? (DH / 16) * slice : kK4Threads;
}

// dynamic shared memory: K and V scales, logits / probabilities, the
// scratch, then the K and V codes
template <int DH>
__host__ __device__ constexpr size_t k4_smem_bytes(int slice) {
  return sizeof(float) * (3 * slice + k4_red_floats<DH>(slice)) +
         2 * static_cast<size_t>(DH) * k4_row_stride(slice);
}

// Four int8 codes, packed low byte first, as exact floats without an
// int-to-float conversion (a quarter of the FMA rate): byte + 128 becomes
// the low mantissa byte of 2^23, and 2^23 + 128 is taken off.
__device__ __forceinline__ float4 codes_f32(uint32_t w) {
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias);
}

// four probabilities times four packed int8 codes, added to acc
__device__ __forceinline__ float dot4(float4 p, uint32_t w, float acc) {
  const float4 c = codes_f32(w);
  acc = fmaf(p.x, c.x, acc);
  acc = fmaf(p.y, c.y, acc);
  acc = fmaf(p.z, c.z, acc);
  return fmaf(p.w, c.w, acc);
}

// grid (splits * bh), cluster (splits, 1, 1): cluster c is (b, h) = c, its
// block of rank r owns positions [r * slice, (r + 1) * slice).
template <typename T, int DH>
__global__ void __launch_bounds__(kK4Threads)
decode_int8_cluster_kernel(const T* __restrict__ q,
                           const int8_t* __restrict__ kc,
                           const float* __restrict__ ks,
                           const int8_t* __restrict__ vc,
                           const float* __restrict__ vs, T* __restrict__ out,
                           int t_pad, int slice) {
  namespace cg = cooperative_groups;
  constexpr int NT = kK4Threads;
  constexpr int kW = NT / 32;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) float qs[DH];
  __shared__ float scratch[kW];
  __shared__ float sums[kW];
  __shared__ float gather[kMaxSplit][DH + 2];  // rank 0's: every block's acc[DH], max, sum

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t bh = blockIdx.x / splits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = rank * slice;
  const int rs = k4_row_stride(slice);

  float* ks_s = reinterpret_cast<float*>(smem);
  float* vs_s = ks_s + slice;
  float* p = vs_s + slice;  // logits, then probabilities times V scales
  float* red = p + slice;
  uint8_t* kc_s = reinterpret_cast<uint8_t*>(red + k4_red_floats<DH>(slice));
  uint8_t* vc_s = kc_s + DH * rs;
  const int chunks = slice / 16;  // 16-byte chunks of a (b, h, d) row's slice

  // 1. the whole slice in flight: both scale vectors and the K codes, then
  // the V codes, each a cp.async group of 16-byte copies. Thread tid copies
  // chunks tid, tid + NT, ... of the (DH, chunks) grid: (d, c) steps by
  // (NT / chunks, NT % chunks) with a carry, no division in the loop.
  const size_t row0 = bh * DH * static_cast<size_t>(t_pad) + t0;
  const float* ksg = ks + bh * t_pad + t0;
  const float* vsg = vs + bh * t_pad + t0;
  for (int i = tid; i < slice / 4; i += NT) {
    wipa::cp_async16(wipa::smem_addr(ks_s + 4 * i), ksg + 4 * i, 16);
    wipa::cp_async16(wipa::smem_addr(vs_s + 4 * i), vsg + 4 * i, 16);
  }
  const int step_d = NT / chunks, step_c = NT - step_d * chunks;
  const int d0 = tid / chunks, c0 = tid - d0 * chunks;
  for (int pass = 0; pass < 2; ++pass) {
    const int8_t* src = (pass ? vc : kc) + row0;
    uint8_t* dst = pass ? vc_s : kc_s;
    for (int d = d0, c = c0; d < DH;) {
      wipa::cp_async16(wipa::smem_addr(dst + d * rs + 16 * c),
                       src + static_cast<size_t>(d) * t_pad + 16 * c, 16);
      d += step_d;
      c += step_c;
      if (c >= chunks) {
        c -= chunks;
        ++d;
      }
    }
    wipa::cp_async_commit();
  }
  if (tid < DH) qs[tid] = to_f32(q[bh * DH + tid]);
  wipa::cp_async_wait<1>();  // this thread's K copies landed
  __syncthreads();           // and everyone's, and q

  // 2. logits from K while V lands: an item is 16 head dims (group g, their
  // q in registers) of four positions; the groups' partial sums are added
  // in order
  constexpr int kGroups = DH / 16;
  const int words = slice / 4;
  for (int i = tid; i < kGroups * words; i += NT) {
    const int g = i / words, w = i - g * words;
    float qv[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(qs + 16 * g)[j];
      qv[4 * j] = f.x;
      qv[4 * j + 1] = f.y;
      qv[4 * j + 2] = f.z;
      qv[4 * j + 3] = f.w;
    }
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int dd = 0; dd < 16; ++dd) {
      const float4 c = codes_f32(
          *reinterpret_cast<const uint32_t*>(kc_s + (16 * g + dd) * rs + 4 * w));
      a0 = fmaf(qv[dd], c.x, a0);
      a1 = fmaf(qv[dd], c.y, a1);
      a2 = fmaf(qv[dd], c.z, a2);
      a3 = fmaf(qv[dd], c.w, a3);
    }
    reinterpret_cast<float4*>(red + g * slice)[w] = make_float4(a0, a1, a2, a3);
  }
  __syncthreads();
  float local_max = -INFINITY;
  for (int t = tid; t < slice; t += NT) {
    float sum = red[t];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) sum += red[g * slice + t];
    const float sc = ks_s[t];
    const float lg = sc > 0.f ? sum * sc : -INFINITY;
    p[t] = lg;
    local_max = fmaxf(local_max, lg);
  }
  const float m = block_reduce<true, NT>(local_max, scratch);

  float local_sum = 0.f;
  for (int t = tid; t < slice; t += NT) {
    const float lg = p[t];
    const float e = lg == -INFINITY ? 0.f : expf(lg - m);
    local_sum += e;
    p[t] = e * vs_s[t];  // fold the V scale into the probability
  }
  local_sum = warp_sum(local_sum);
  if (lane == 0) sums[warp] = local_sum;
  wipa::cp_async_wait<0>();  // this thread's V copies landed
  __syncthreads();           // everyone's, p and the warps' sums

  // 3. p . v_codes: a thread owns head dim d and every (NT / DH)-th
  // 16-position chunk; the threads of a dim add their sums in order
  constexpr int kPerDim = NT / DH;
  const int d = tid % DH;
  float acc = 0.f;
  for (int c = tid / DH; c < slice / 16; c += kPerDim) {
    const uint4 u = *reinterpret_cast<const uint4*>(vc_s + d * rs + 16 * c);
    const float4* pp = reinterpret_cast<const float4*>(p + 16 * c);
    acc = dot4(pp[0], u.x, acc);
    acc = dot4(pp[1], u.y, acc);
    acc = dot4(pp[2], u.z, acc);
    acc = dot4(pp[3], u.w, acc);
  }
  red[tid] = acc;
  __syncthreads();

  // 4. merge the cluster's slices in rank 0: each block writes its (acc,
  // max, sum) into rank 0's shared memory, one barrier publishes them, and
  // the other blocks leave; nothing reads their shared memory
  float* slot = cluster.map_shared_rank(&gather[0][0], 0) + rank * (DH + 2);
  if (tid < DH) {
    float sum = red[tid];
#pragma unroll
    for (int j = 1; j < kPerDim; ++j) sum += red[j * DH + tid];
    slot[tid] = sum;
  }
  if (tid == 0) {
    float l = sums[0];
#pragma unroll
    for (int w = 1; w < kW; ++w) l += sums[w];
    slot[DH] = m;
    slot[DH + 1] = l;
  }
  cluster.sync();
  if (rank == 0 && tid < DH) {
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, gather[r][DH]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float ms = gather[r][DH];
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      num = fmaf(w, gather[r][tid], num);
      den = fmaf(w, gather[r][DH + 1], den);
    }
    out[bh * DH + tid] = from_f32<T>(num / den);  // all keys masked: 0/0 = NaN
  }
}

template <typename T, int DH>
cudaError_t launch_int8(const void* q, const void* kc, const void* ks,
                        const void* vc, const void* vs, void* out, int bh,
                        int t_pad, int splits, int slice, cudaStream_t stream) {
  auto kernel = decode_int8_cluster_kernel<T, DH>;
  static bool attr_set = false;  // once for each instance, for any slice
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(k4_smem_bytes<DH>(kMaxSlice)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * bh);
  cfg.blockDim = dim3(kK4Threads);
  cfg.dynamicSmemBytes = k4_smem_bytes<DH>(slice);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<T*>(out), t_pad, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// -- K8: two passes -----------------------------------------------------------

__device__ __forceinline__ float nib_lo(int8_t b) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(static_cast<int>(b)) << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(int8_t b) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(static_cast<int>(b)) << 24) >> 28);
}

// K8 pass 1. grid (n_split, bh); dynamic shared memory: chunk floats.
// kp/vp: (bh, DH, t_pad / 2) packed; ks/vs: (bh, t_pad) f32.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_partial_int4_kernel(const T* __restrict__ q,
                           const int8_t* __restrict__ kp,
                           const float* __restrict__ ks,
                           const int8_t* __restrict__ vp,
                           const float* __restrict__ vs,
                           float* __restrict__ part, int t_pad, int chunk) {
  extern __shared__ __align__(16) float p[];
  __shared__ float qs[DH];
  __shared__ float scratch[kWarps];

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const size_t bh = blockIdx.y;
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, t_pad);
  const int n8 = (t1 - t0) / 8;  // char4 words, eight positions each
  const int row4 = t_pad / 8;    // char4 words per (b, h, d) row

  if (threadIdx.x < DH) qs[threadIdx.x] = to_f32(q[bh * DH + threadIdx.x]);
  __syncthreads();

  const char4* k4 = reinterpret_cast<const char4*>(kp + bh * DH * (t_pad / 2)) + t0 / 8;
  const float4* ks4 = reinterpret_cast<const float4*>(ks + bh * t_pad) + t0 / 4;
  float local_max = -INFINITY;
  for (int i = threadIdx.x; i < n8; i += kThreads) {
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const char4 c = k4[static_cast<size_t>(d) * row4 + i];
      const float qd = qs[d];
      a[0] = fmaf(qd, nib_lo(c.x), a[0]);
      a[1] = fmaf(qd, nib_hi(c.x), a[1]);
      a[2] = fmaf(qd, nib_lo(c.y), a[2]);
      a[3] = fmaf(qd, nib_hi(c.y), a[3]);
      a[4] = fmaf(qd, nib_lo(c.z), a[4]);
      a[5] = fmaf(qd, nib_hi(c.z), a[5]);
      a[6] = fmaf(qd, nib_lo(c.w), a[6]);
      a[7] = fmaf(qd, nib_hi(c.w), a[7]);
    }
    const float4 s0 = ks4[2 * i];
    const float4 s1 = ks4[2 * i + 1];
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      l[e] = sc[e] > 0.f ? a[e] * sc[e] : -INFINITY;
      local_max = fmaxf(local_max, l[e]);
    }
    reinterpret_cast<float4*>(p)[2 * i] = make_float4(l[0], l[1], l[2], l[3]);
    reinterpret_cast<float4*>(p)[2 * i + 1] = make_float4(l[4], l[5], l[6], l[7]);
  }
  const float m = block_reduce<true>(local_max, scratch);

  const float* vsb = vs + bh * t_pad + t0;
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < t1 - t0; t += kThreads) {
    const float lg = p[t];
    const float e = lg == -INFINITY ? 0.f : expf(lg - m);
    local_sum += e;
    p[t] = e * vsb[t];  // fold the V scale into the probability
  }
  const float l = block_reduce<false>(local_sum, scratch);  // syncs p too

  const char4* v4 = reinterpret_cast<const char4*>(vp + bh * DH * (t_pad / 2)) + t0 / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* out = part + (bh * n_split + split) * (DH + 2);
  for (int d = warp; d < DH; d += kWarps) {
    float acc = 0.f;
    for (int i = lane; i < n8; i += 32) {
      const char4 c = v4[static_cast<size_t>(d) * row4 + i];
      const float4 p0 = reinterpret_cast<const float4*>(p)[2 * i];
      const float4 p1 = reinterpret_cast<const float4*>(p)[2 * i + 1];
      acc = fmaf(p0.x, nib_lo(c.x), acc);
      acc = fmaf(p0.y, nib_hi(c.x), acc);
      acc = fmaf(p0.z, nib_lo(c.y), acc);
      acc = fmaf(p0.w, nib_hi(c.y), acc);
      acc = fmaf(p1.x, nib_lo(c.z), acc);
      acc = fmaf(p1.y, nib_hi(c.z), acc);
      acc = fmaf(p1.z, nib_lo(c.w), acc);
      acc = fmaf(p1.w, nib_hi(c.w), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[d] = acc;
  }
  if (threadIdx.x == 0) {
    out[DH] = m;
    out[DH + 1] = l;
  }
}

// grid (bh,), DH threads: merge the splits and divide by the row sum.
template <typename T, int DH>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pb = part + bh * n_split * (DH + 2);
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pb[s * (DH + 2) + DH]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = pb[s * (DH + 2) + DH];
    const float w = ms == -INFINITY ? 0.f : expf(ms - m);
    num = fmaf(w, pb[s * (DH + 2) + d], num);
    den = fmaf(w, pb[s * (DH + 2) + DH + 1], den);
  }
  out[bh * DH + d] = from_f32<T>(num / den);  // all keys masked: 0/0 = NaN
}

template <typename T, int DH>
cudaError_t launch_int4(const void* q, const void* kc, const void* ks,
                        const void* vc, const void* vs, void* out, void* part,
                        int bh, int t_pad, int n_split, int chunk,
                        cudaStream_t stream) {
  const dim3 grid(n_split, bh);
  decode_partial_int4_kernel<T, DH><<<grid, kThreads, chunk * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<float*>(part), t_pad, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, DH><<<bh, DH, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n_split);
  return cudaGetLastError();
}

}  // namespace

// K4. q: (bh, dh) bf16 or f32 (is_bf16), already scaled by dh^-0.5;
// k_codes, v_codes: (bh, dh, t_pad) int8; k_scale, v_scale: (bh, t_pad) f32;
// out: (bh, dh) in q's type; every pointer 16-byte aligned. One launch of
// bh clusters of `splits` (1..8) blocks, each over `slice` positions:
// splits * slice == t_pad, t_pad % 128 == 0, slice % 16 == 0, at most 1024;
// dh in {32, 64}. Returns cudaGetLastError().
extern "C" int wipa_decode_attention_int8(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, int bh, int dh,
    int t_pad, int splits, int slice, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bh <= 0 || t_pad <= 0 || t_pad % 128 || splits < 1 ||
      splits > kMaxSplit || slice <= 0 || slice % 16 || slice > kMaxSlice ||
      splits * slice != t_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WIPA_DECODE(T, DH)                                                               \
  launch_int8<T, DH>(q, k_codes, k_scale, v_codes, v_scale, out, bh, t_pad, splits, slice, s)
  if (dh == 64) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 64) : WIPA_DECODE(float, 64);
  } else if (dh == 32) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 32) : WIPA_DECODE(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIPA_DECODE
  return static_cast<int>(err);
}

// K8. As K4 but k_codes, v_codes are (bh, dh, t_pad / 2) nibble-packed, and
// two launches (n_split blocks of `chunk` positions a (b, h), then the
// merge) through part: (bh, n_split, dh + 2) f32 scratch. chunk % 128 == 0,
// n_split * chunk >= t_pad, chunk * 4 bytes <= 32 KB. Returns
// cudaGetLastError().
extern "C" int wipa_decode_attention_int4(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, void* part, int bh,
    int dh, int t_pad, int n_split, int chunk, int is_bf16, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t_pad % 128 || chunk % 128 || chunk <= 0 ||
      static_cast<long>(n_split) * chunk < t_pad ||
      chunk * sizeof(float) > 32 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WIPA_DECODE(T, DH)                                                  \
  launch_int4<T, DH>(q, k_codes, k_scale, v_codes, v_scale, out, part, bh, \
                     t_pad, n_split, chunk, s)
  if (dh == 64) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 64) : WIPA_DECODE(float, 64);
  } else if (dh == 32) {
    err = is_bf16 ? WIPA_DECODE(__nv_bfloat16, 32) : WIPA_DECODE(float, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIPA_DECODE
  return static_cast<int>(err);
}
