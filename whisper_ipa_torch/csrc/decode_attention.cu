// Single-query cross-attention over the int8 (K4) and the nibble-packed int4
// (K8) T-minor caches, for Hopper (sm_90a).
//
// K4 replaces: whisper_ipa_tpu/ops/decode_attention.py,
// decode_cross_attention_int8_tminor (:83, pallas_call :112, body _kernel
// :46). K8 replaces: decode_cross_attention_int4_tminor (:188, pallas_call
// :236, body _kernel_int4 :122).
//
// For each (b, h), with q pre-scaled by Dh^-0.5, codes (Dh, T_pad) and
// scales (T_pad,) f32 where scale 0 marks a padded position:
//   logit_t = (q . k_codes[:, t]) * k_scale_t   (-inf where k_scale_t == 0)
//   out     = sum_t exp(logit_t - max) * v_scale_t * v_codes[:, t]
//             / sum_t exp(logit_t - max)
// K4's codes are int8, one a byte. K8's are 4-bit: byte t2 of a (b, h, d)
// row holds position 2*t2 in its low nibble and 2*t2+1 in its high, each a
// two's-complement code; the scales keep the natural (B, H, T_pad) order.
//
// What bounds it on the H100: device-memory bytes. Each decode step of each
// decoder layer reads the whole cache once (2 * B * H * Dh * T_pad bytes
// for int8, half that for int4, plus f32 scales: ~40 MB a layer for int8
// at whisper-small, batch 16) and does ~2 FLOPs per byte, far below the
// ridge. Without these kernels eager PyTorch would first write a bf16 copy
// of the cache (two planes of it for int4), several times the bytes.
//
// One design, one body for both (decode_cluster_body, templated on the
// code width): one launch, the whole slice in flight. A thread-block
// cluster of up to 8 blocks of 256 threads splits T for each (b, h) (K4: 6
// slices of 256 positions at T_pad 1536; K8, from k8_split_plan: 2 slices
// of 768 where B*H fills the SMs, 6 of 256 where it does not, multiples of
// 32 positions so a packed row segment is whole 16-byte copies, the last
// one possibly shorter). A block issues all of
// its slice's K codes and both scale vectors as one cp.async group and its
// V codes as a second, 16 bytes a copy, so the V bytes stream while the
// logits are taken from K in shared memory. The codes become floats
// without int-to-float conversions (a quarter of the FMA rate): an int8
// code + 128, or a 4-bit code + 8 (XOR with 0x88888888, the nibble planes
// split by masks), becomes the low mantissa byte of 2^23 by a byte
// permute, and 2^23 + 128 (or + 8) is taken off: exact for every code. A
// word of int4 codes gives its eight logits in position order, so the
// max and the row sum are taken over both nibble planes together. The
// logits, their max and row sum stay in f32; the V scales fold into the
// probabilities; each thread then owns one head dimension of p . v_codes
// over a share of the slice. Each block writes its (acc[Dh], max, sum)
// into the shared memory of the cluster's rank 0; one cluster barrier
// publishes them, the other blocks leave, and rank 0 rescales, divides
// once and writes out. No scratch tensor and no second kernel.
//
// The blocks of a wave load together and then compute together, so a
// block's work after its loads lands is on the critical path: what
// shortened K4 was one cluster barrier instead of two, 256 threads and
// 256-position slices. A persistent, double-buffered form (a cluster
// walking several (b, h)) and cp.async.bulk copies of each row segment
// were tried on the H100 and were slower.

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
template <bool kMax, int NT>
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

constexpr int kMaxSplit = 8;  // blocks a cluster (the portable maximum)
constexpr int kThreads = 256;  // threads a block

// positions a block at most: its codes fill shared memory
template <int BITS>
constexpr int max_slice() { return BITS == 8 ? 1024 : 2048; }

// Row stride in shared memory of a slice's codes, in bytes: the slice's
// bytes when they are an odd number of 16-byte chunks, else one chunk
// more, so that eight consecutive rows' 16-byte reads fall in eight
// distinct bank groups.
template <int BITS>
__host__ __device__ constexpr int row_stride(int slice) {
  return (slice * BITS / 128) % 2 ? slice * BITS / 8 : slice * BITS / 8 + 16;
}

// floats of the scratch that holds the logits' partial sums (DH / 16 groups
// of `slice`), then the value rows' partial sums (one a thread)
template <int DH>
__host__ __device__ constexpr int red_floats(int slice) {
  return (DH / 16) * slice > kThreads ? (DH / 16) * slice : kThreads;
}

// dynamic shared memory: K and V scales, logits / probabilities, the
// scratch, then the K and V codes
template <int DH, int BITS>
__host__ __device__ constexpr size_t smem_bytes(int slice) {
  return sizeof(float) * (3 * slice + red_floats<DH>(slice)) +
         2 * static_cast<size_t>(DH) * row_stride<BITS>(slice);
}

// The code widths: a 32-bit word of a row holds kPerWord positions. qk
// adds one head dim's q times a word's codes to the word's logits; pv adds
// a word's probabilities times its codes, in position order.
template <int BITS>
struct Codes;

template <>
struct Codes<8> {
  static constexpr int kPerWord = 4;

  // Four int8 codes, packed low byte first, as exact floats: byte + 128
  // becomes the low mantissa byte of 2^23, and 2^23 + 128 is taken off.
  static __device__ __forceinline__ float4 widen(uint32_t w) {
    constexpr float kBias = 8388736.f;  // 2^23 + 128
    const uint32_t u = w ^ 0x80808080u;
    return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias,
                       __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias);
  }
  static __device__ __forceinline__ void qk(float qd, uint32_t w, float (&a)[4]) {
    const float4 c = widen(w);
    a[0] = fmaf(qd, c.x, a[0]);
    a[1] = fmaf(qd, c.y, a[1]);
    a[2] = fmaf(qd, c.z, a[2]);
    a[3] = fmaf(qd, c.w, a[3]);
  }
  static __device__ __forceinline__ void store(float* dst, const float (&a)[4]) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  }
  static __device__ __forceinline__ float pv(const float* p, uint32_t w, float acc) {
    const float4 pp = reinterpret_cast<const float4*>(p)[0];
    const float4 c = widen(w);
    acc = fmaf(pp.x, c.x, acc);
    acc = fmaf(pp.y, c.y, acc);
    acc = fmaf(pp.z, c.z, acc);
    return fmaf(pp.w, c.w, acc);
  }
};

template <>
struct Codes<4> {
  static constexpr int kPerWord = 8;

  // Eight 4-bit codes as exact floats: lo holds positions 0, 2, 4, 6 (the
  // low nibbles), hi 1, 3, 5, 7. XOR with 8 turns a two's-complement
  // nibble into code + 8; the masks split the planes; each byte becomes
  // the low mantissa byte of 2^23, and 2^23 + 8 is taken off.
  static __device__ __forceinline__ void widen(uint32_t w, float4& lo, float4& hi) {
    constexpr float kBias = 8388616.f;  // 2^23 + 8
    const uint32_t u = w ^ 0x88888888u;
    const uint32_t e = u & 0x0F0F0F0Fu;
    const uint32_t o = (u >> 4) & 0x0F0F0F0Fu;
    lo = make_float4(__uint_as_float(__byte_perm(e, 0x4B000000u, 0x7540)) - kBias,
                     __uint_as_float(__byte_perm(e, 0x4B000000u, 0x7541)) - kBias,
                     __uint_as_float(__byte_perm(e, 0x4B000000u, 0x7542)) - kBias,
                     __uint_as_float(__byte_perm(e, 0x4B000000u, 0x7543)) - kBias);
    hi = make_float4(__uint_as_float(__byte_perm(o, 0x4B000000u, 0x7540)) - kBias,
                     __uint_as_float(__byte_perm(o, 0x4B000000u, 0x7541)) - kBias,
                     __uint_as_float(__byte_perm(o, 0x4B000000u, 0x7542)) - kBias,
                     __uint_as_float(__byte_perm(o, 0x4B000000u, 0x7543)) - kBias);
  }
  static __device__ __forceinline__ void qk(float qd, uint32_t w, float (&a)[8]) {
    float4 lo, hi;
    widen(w, lo, hi);
    a[0] = fmaf(qd, lo.x, a[0]);
    a[1] = fmaf(qd, hi.x, a[1]);
    a[2] = fmaf(qd, lo.y, a[2]);
    a[3] = fmaf(qd, hi.y, a[3]);
    a[4] = fmaf(qd, lo.z, a[4]);
    a[5] = fmaf(qd, hi.z, a[5]);
    a[6] = fmaf(qd, lo.w, a[6]);
    a[7] = fmaf(qd, hi.w, a[7]);
  }
  static __device__ __forceinline__ void store(float* dst, const float (&a)[8]) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
  static __device__ __forceinline__ float pv(const float* p, uint32_t w, float acc) {
    const float4 p0 = reinterpret_cast<const float4*>(p)[0];
    const float4 p1 = reinterpret_cast<const float4*>(p)[1];
    float4 lo, hi;
    widen(w, lo, hi);
    acc = fmaf(p0.x, lo.x, acc);
    acc = fmaf(p0.y, hi.x, acc);
    acc = fmaf(p0.z, lo.y, acc);
    acc = fmaf(p0.w, hi.y, acc);
    acc = fmaf(p1.x, lo.z, acc);
    acc = fmaf(p1.y, hi.z, acc);
    acc = fmaf(p1.z, lo.w, acc);
    return fmaf(p1.w, hi.w, acc);
  }
};

// grid (splits * bh), cluster (splits, 1, 1): cluster c is (b, h) = c, its
// block of rank r owns positions [r * slice, min((r + 1) * slice, t_pad)).
// kc, vc: (bh, DH, t_pad * BITS / 8) bytes; ks, vs: (bh, t_pad) f32.
template <typename T, int DH, int BITS>
__device__ __forceinline__ void decode_cluster_body(
    const T* __restrict__ q, const int8_t* __restrict__ kc,
    const float* __restrict__ ks, const int8_t* __restrict__ vc,
    const float* __restrict__ vs, T* __restrict__ out, int t_pad, int slice) {
  namespace cg = cooperative_groups;
  using C = Codes<BITS>;
  constexpr int NT = kThreads;
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
  const int n = min(slice, t_pad - t0);  // this block's positions
  const int rs = row_stride<BITS>(slice);
  const size_t row_bytes = static_cast<size_t>(t_pad) * BITS / 8;

  float* ks_s = reinterpret_cast<float*>(smem);
  float* vs_s = ks_s + slice;
  float* p = vs_s + slice;  // logits, then probabilities times V scales
  float* red = p + slice;
  uint8_t* kc_s = reinterpret_cast<uint8_t*>(red + red_floats<DH>(slice));
  uint8_t* vc_s = kc_s + DH * rs;
  const int chunks = n * BITS / 128;  // 16-byte chunks of a (b, h, d) row's slice

  // 1. the whole slice in flight: both scale vectors and the K codes, then
  // the V codes, each a cp.async group of 16-byte copies. Thread tid copies
  // chunks tid, tid + NT, ... of the (DH, chunks) grid: (d, c) steps by
  // (NT / chunks, NT % chunks) with a carry, no division in the loop.
  const size_t row0 = bh * DH * row_bytes + static_cast<size_t>(t0) * BITS / 8;
  const float* ksg = ks + bh * t_pad + t0;
  const float* vsg = vs + bh * t_pad + t0;
  for (int i = tid; i < n / 4; i += NT) {
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
                       src + static_cast<size_t>(d) * row_bytes + 16 * c, 16);
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
  // q in registers) of one 32-bit word of codes; the groups' partial sums
  // are added in order
  constexpr int kGroups = DH / 16;
  const int words = n / C::kPerWord;
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
    float a[C::kPerWord];
#pragma unroll
    for (int e = 0; e < C::kPerWord; ++e) a[e] = 0.f;
#pragma unroll
    for (int dd = 0; dd < 16; ++dd) {
      C::qk(qv[dd], *reinterpret_cast<const uint32_t*>(kc_s + (16 * g + dd) * rs + 4 * w), a);
    }
    C::store(red + g * slice + C::kPerWord * w, a);
  }
  __syncthreads();
  float local_max = -INFINITY;
  for (int t = tid; t < n; t += NT) {
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
  for (int t = tid; t < n; t += NT) {
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
  // 16-byte chunk of its row; the threads of a dim add their sums in order
  constexpr int kPerDim = NT / DH;
  constexpr int kPerChunk = 4 * C::kPerWord;  // positions a 16-byte chunk
  const int d = tid % DH;
  float acc = 0.f;
  for (int c = tid / DH; c < chunks; c += kPerDim) {
    const uint4 u = *reinterpret_cast<const uint4*>(vc_s + d * rs + 16 * c);
    const float* pc = p + kPerChunk * c;
    acc = C::pv(pc, u.x, acc);
    acc = C::pv(pc + C::kPerWord, u.y, acc);
    acc = C::pv(pc + 2 * C::kPerWord, u.z, acc);
    acc = C::pv(pc + 3 * C::kPerWord, u.w, acc);
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

// K4 and K8 are two kernels (two names in a profile) of the one body.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_int8_cluster_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                           const float* __restrict__ ks, const int8_t* __restrict__ vc,
                           const float* __restrict__ vs, T* __restrict__ out,
                           int t_pad, int slice) {
  decode_cluster_body<T, DH, 8>(q, kc, ks, vc, vs, out, t_pad, slice);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_int4_cluster_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                           const float* __restrict__ ks, const int8_t* __restrict__ vc,
                           const float* __restrict__ vs, T* __restrict__ out,
                           int t_pad, int slice) {
  decode_cluster_body<T, DH, 4>(q, kc, ks, vc, vs, out, t_pad, slice);
}

template <typename T, int DH, int BITS>
cudaError_t launch(const void* q, const void* kc, const void* ks, const void* vc,
                   const void* vs, void* out, int bh, int t_pad, int splits,
                   int slice, cudaStream_t stream) {
  auto kernel = BITS == 8 ? &decode_int8_cluster_kernel<T, DH>
                          : &decode_int4_cluster_kernel<T, DH>;
  static bool attr_set = false;  // once for each instance, for any slice
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<DH, BITS>(max_slice<BITS>())));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<DH, BITS>(slice);
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

template <int BITS>
int dispatch(const void* q, const void* k_codes, const void* k_scale,
             const void* v_codes, const void* v_scale, void* out, int bh, int dh,
             int t_pad, int splits, int slice, int is_bf16, cudaStream_t s) {
  cudaError_t err;
#define WIPA_DECODE(T, DH) \
  launch<T, DH, BITS>(q, k_codes, k_scale, v_codes, v_scale, out, bh, t_pad, splits, slice, s)
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
      splits > kMaxSplit || slice <= 0 || slice % 16 || slice > max_slice<8>() ||
      splits * slice != t_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<8>(q, k_codes, k_scale, v_codes, v_scale, out, bh, dh, t_pad,
                     splits, slice, is_bf16, static_cast<cudaStream_t>(stream));
}

// K8. As K4 but k_codes, v_codes are (bh, dh, t_pad / 2) nibble-packed, and
// the slices are multiples of 32 positions (whole 16-byte copies of a
// packed row segment), at most 2048, the last one possibly shorter:
// splits * slice >= t_pad > (splits - 1) * slice. One launch, no scratch.
// Returns cudaGetLastError().
extern "C" int wipa_decode_attention_int4(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, int bh, int dh,
    int t_pad, int splits, int slice, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bh <= 0 || t_pad <= 0 || t_pad % 128 || splits < 1 ||
      splits > kMaxSplit || slice <= 0 || slice % 32 || slice > max_slice<4>() ||
      static_cast<long>(splits) * slice < t_pad ||
      static_cast<long>(splits - 1) * slice >= t_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<4>(q, k_codes, k_scale, v_codes, v_scale, out, bh, dh, t_pad,
                     splits, slice, is_bf16, static_cast<cudaStream_t>(stream));
}
