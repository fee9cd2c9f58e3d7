// Stochastic-rounding int8 weight quantization for Hopper (sm_90a): one
// launch quantizes a whole list of weights (a model's parameter tree).
//
// Replaces: whisper_ipa_tpu/ops/sr_quant.py, stochastic_quantize_int8
// (:69, pallas_call :94, body _sr_quant_kernel :34), and the per-weight
// loop of quantize_params_device (:130).
//
// Each weight w (in, out) f32, row-major -> codes (in, out) int8 and
// scales (out,) f32:
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
// the Random123 constants), key (seed, 0). The uniforms of columns 4j ..
// 4j+3 of row r are words 0..3 of the block at counter (j, r, 0, 0): one
// Philox block a 4 elements. u is the top 23 bits as a mantissa in [1, 2),
// minus 1, as the TPU kernel builds it. A code's bits are a pure function
// of (seed, row, col), independent of the grid, and the plain version
// recomputes them exactly.
//
// What bounds it on the H100: bytes. A weight is read once (4 B) and its
// codes written once (1 B): 0.99 GB for whisper-small's 192 block weights,
// 0.296 ms at 3.35 TB/s. The work is ~35 operations an element (a quarter
// of a Philox block, the division, the rounding, |w| and the max).
//
// Design:
// - One launch for the list. The host passes a table of the weights
//   (pointers, shape, seed, strip width, first tile) as the kernel's one
//   parameter (__grid_constant__, up to kMaxEntries; CUDA >= 12.1 allows
//   32 764 bytes of parameters), so no copy precedes the launch; a single
//   weight (wipa_sr_quant_int8) passes a table of one, 56 bytes. A tile
//   is a strip of 32, 64 or 128 columns of one weight over all its rows;
//   a cluster finds its weight by a binary search over the first tiles
//   (every thread the same index, so the parameter reads broadcast).
// - One read of each weight from HBM. A strip belongs to a thread-block
//   cluster of kCluster blocks along its rows; block `rank` owns rows
//   [rank * slice, (rank + 1) * slice), slice = ceil(rows / kCluster).
//   It copies its slice into shared memory with 16-byte cp.async (4-byte
//   ones where the columns are not a multiple of 4 or the weight is not
//   16-byte aligned; zero-filled past the last column), reduces its
//   per-column max|w|, and pushes the strip's partial maxima into every
//   block of the cluster (distributed shared memory); one cluster barrier
//   publishes them, each block takes the scale of its columns from the
//   kCluster partials and quantizes from what it holds. A slice larger
//   than the launch's stage (kMaxStage floats, 96 KB: rows > 6144 at 32
//   columns) is read from device memory twice instead, in the same kernel.
// - Equal work a block. A block's life (loads, barriers, Philox, stores)
//   is mostly latency, so the card needs many bytes in flight a block.
//   The host (ops/sr_quant.sr_quant_plan) sizes the stage by the tallest
//   slice at 32 columns and gives each shorter weight the widest strip
//   whose slice fits the same stage: whisper-small's (3072, 768) weights
//   take 384 x 32, its (768, *) weights 96 x 128, 48 KB a block either
//   way (4 blocks an SM). Tiles go out most floats first.
// - A thread owns 4 neighbouring columns of a row: one 16-byte load, one
//   Philox block, one 4-byte store of the codes. A warp covers 1, 2 or 4
//   rows of its strip, 512 contiguous bytes of w.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;        // blocks a cluster, along rows
constexpr int kMaxStrip = 128;     // columns a tile: 32, 64 or 128
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStage = 24576;   // floats of a block's slice: 96 KB

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// One weight. The layout is ops/sr_quant._Entry's.
struct Entry {
  const float* w;
  int8_t* q;
  float* s;
  int rows;
  int cols;
  uint32_t seed;
  int tile0;  // the first tile of this weight; entries in tile order
  int strip;  // columns a tile of this weight
};
static_assert(sizeof(Entry) == 48, "ops/sr_quant._Entry, padded to 8 bytes");

constexpr int kMaxEntries = 640;
// The kernel's parameter: kEntries entries (1 for a single weight, so its
// launch passes 56 bytes, not 30 KB; kMaxEntries for a list).
template <int kEntries>
struct Table {
  Entry e[kEntries];
  int n;      // entries in use
  int stage;  // floats of a slice that the launch's shared memory holds
};
static_assert(sizeof(Table<kMaxEntries>) <= 32764, "kernel parameter limit");

// Philox4x32-10: the block at counter (c0, c1, 0, 0), key (k0, 0).
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1, uint32_t k0) {
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
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ int code(float w, float s, uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float f = floorf(__fadd_rn(w / s, u));  // IEEE division
  return static_cast<int>(fminf(fmaxf(f, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes (4 or 16); zero-filled where `in` is false
// (the source is then not read).
template <int size>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (size == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

// 4 columns [col, col + 4) of one row from device memory, 0 past cols.
__device__ __forceinline__ float4 load4(const float* row, int col, int cols,
                                        bool vec) {
  if (vec) {
    return col < cols ? __ldg(reinterpret_cast<const float4*>(row + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = col + k < cols ? __ldg(row + col + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 fmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// grid (tiles * kCluster), cluster (kCluster, 1, 1), kThreads threads,
// dynamic shared memory table.stage floats.
template <int kEntries>
__global__ void __launch_bounds__(kThreads)
sr_quant_kernel(const __grid_constant__ Table<kEntries> table) {
  extern __shared__ __align__(16) float4 stage[];  // [slice][strip / 4]
  __shared__ __align__(16) float red[kWarps][kMaxStrip];
  __shared__ __align__(16) float gather[kCluster][kMaxStrip];  // every rank's maxima

  // every block of the cluster has started before any writes into another
  // block's shared memory (the wait below); arrive now, wait later
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = static_cast<int>(blockIdx.x / kCluster);

  // the weight: the last entry whose first tile is at or before this one
  int lo = 0, hi = table.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.e[mid].tile0 <= tile) lo = mid;
    else hi = mid - 1;
  }
  const Entry& e = table.e[lo];
  const int rows = e.rows, cols = e.cols, strip = e.strip;
  const int slice = (rows + kCluster - 1) / kCluster;
  const int row0 = rank * slice;
  const int n = max(0, min(slice, rows - row0));  // this block's rows
  const bool staged = slice * strip <= table.stage;
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(e.w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e.q) % 4 == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = strip / 4;       // 4-column groups a row of the strip
  const int row_lanes = kThreads / groups;  // rows a pass of the block
  const int g = tid % groups;         // this thread's 4-column group
  const int lane_row = tid / groups;  // its first row of the slice
  const int col = (tile - e.tile0) * strip + 4 * g;
  const float* w = e.w + static_cast<size_t>(row0) * cols;

  // 1. the slice into shared memory; each thread reads back only what it
  // copied itself, so its own wait suffices
  if (staged) {
    for (int i = lane_row; i < n; i += row_lanes) {
      const float* src = w + static_cast<size_t>(i) * cols + col;
      float4* dst = &stage[i * groups + g];
      if (vec) {
        cp_async<16>(dst, col < cols ? src : e.w, col < cols);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          cp_async<4>(reinterpret_cast<float*>(dst) + k,
                      col + k < cols ? src + k : e.w, col + k < cols);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }

  // 2. max|w| of each column over the slice, then over the block
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = lane_row; i < n; i += row_lanes) {
    const float4 x = staged ? stage[i * groups + g]
                            : load4(w + static_cast<size_t>(i) * cols, col, cols, vec);
    m = fmax4(m, make_float4(fabsf(x.x), fabsf(x.y), fabsf(x.z), fabsf(x.w)));
  }
#pragma unroll
  for (int off = groups; off < 32; off <<= 1) {
    m.x = fmaxf(m.x, __shfl_xor_sync(0xFFFFFFFFu, m.x, off));
    m.y = fmaxf(m.y, __shfl_xor_sync(0xFFFFFFFFu, m.y, off));
    m.z = fmaxf(m.z, __shfl_xor_sync(0xFFFFFFFFu, m.z, off));
    m.w = fmaxf(m.w, __shfl_xor_sync(0xFFFFFFFFu, m.w, off));
  }
  if (lane < groups) *reinterpret_cast<float4*>(&red[warp][4 * lane]) = m;
  __syncthreads();

  // 3. the block's strip maxima into every rank's gather[rank]; one barrier
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int p = tid; p < kCluster * strip; p += kThreads) {
    const int c = p % strip;
    float v = red[0][c];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v = fmaxf(v, red[k][c]);
    *cluster.map_shared_rank(&gather[rank][c], p / strip) = v;
  }
  cluster.sync();

  float4 amax = *reinterpret_cast<const float4*>(&gather[0][4 * g]);
#pragma unroll
  for (int r = 1; r < kCluster; ++r)
    amax = fmax4(amax, *reinterpret_cast<const float4*>(&gather[r][4 * g]));
  const float sc[4] = {fmaxf(amax.x, 1e-8f) / 127.0f, fmaxf(amax.y, 1e-8f) / 127.0f,
                       fmaxf(amax.z, 1e-8f) / 127.0f, fmaxf(amax.w, 1e-8f) / 127.0f};
  if (rank == 0 && lane_row == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < cols) e.s[col + k] = sc[k];
  }
  if (col >= cols) return;

  // 4. codes: one Philox block and one 4-byte store a thread and row
  const uint32_t j = static_cast<uint32_t>(col) >> 2;
  for (int i = lane_row; i < n; i += row_lanes) {
    const size_t off = static_cast<size_t>(i) * cols;
    const float4 x = staged ? stage[i * groups + g] : load4(w + off, col, cols, vec);
    const uint4 b = philox4(j, static_cast<uint32_t>(row0 + i), e.seed);
    const int q0 = code(x.x, sc[0], b.x), q1 = code(x.y, sc[1], b.y);
    const int q2 = code(x.z, sc[2], b.z), q3 = code(x.w, sc[3], b.w);
    int8_t* dst = e.q + static_cast<size_t>(row0) * cols + off + col;
    if (vec) {
      *reinterpret_cast<uint32_t*>(dst) =
          (q0 & 0xFF) | (q1 & 0xFF) << 8 | (q2 & 0xFF) << 16 |
          static_cast<uint32_t>(q3 & 0xFF) << 24;
    } else {
      const int qs[4] = {q0, q1, q2, q3};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col + k < cols) dst[k] = static_cast<int8_t>(qs[k]);
    }
  }
}

template <int kEntries>
cudaError_t launch(const Entry* entries, int n, int tiles, int stage,
                   cudaStream_t stream) {
  static bool attr_set = false;
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(sr_quant_kernel<kEntries>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxStage * 4);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  Table<kEntries> table;
  memcpy(table.e, entries, sizeof(Entry) * n);
  table.n = n;
  table.stage = stage;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(stage) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sr_quant_kernel<kEntries>, table);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// entries: n host-side Entry records (ops/sr_quant._Entry), in tile order,
// 1 <= n <= 640, each weight (rows, cols) f32 row-major, codes (rows,
// cols) int8, scales (cols,) f32, on `device`, its strip 32, 64 or 128;
// tiles: the tiles of all entries (ceil(cols / strip) each); stage: the
// floats of a slice that shared memory holds, a multiple of 4 up to 24576
// (a weight whose slice * strip is larger is read twice).
// Returns cudaGetLastError().
extern "C" int wipa_sr_quant_int8_many(const void* entries, int n, int tiles,
                                       int stage, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxEntries || tiles < 1 || stage < 0 || stage > kMaxStage ||
      stage % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Entry* e = static_cast<const Entry*>(entries);
  for (int i = 0; i < n; ++i)
    if (e[i].strip != 32 && e[i].strip != 64 && e[i].strip != kMaxStrip)
      return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n == 1 ? launch<1>(e, n, tiles, stage, s)
                                 : launch<kMaxEntries>(e, n, tiles, stage, s));
}

// One weight w (rows, cols) f32 row-major -> codes q (rows, cols) int8 and
// scales s (cols,) f32, on `device`: the launch that sr_quant_plan gives a
// list of one (strips of 32 columns; the slice in shared memory if it
// holds at most kMaxStage floats, else read twice), with no table built
// on the host. Returns cudaGetLastError().
extern "C" int wipa_sr_quant_int8(const void* w, void* q, void* s, int rows,
                                  int cols, uint32_t seed, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (rows + kCluster - 1) / kCluster;
  const int stage = slice * 32 <= kMaxStage ? slice * 32 : 0;
  const Entry e = {static_cast<const float*>(w), static_cast<int8_t*>(q),
                   static_cast<float*>(s), rows, cols, seed, 0, 32};
  return static_cast<int>(launch<1>(&e, 1, (cols + 31) / 32, stage,
                                    static_cast<cudaStream_t>(stream)));
}

// The launch geometry, for the wrapper to hold its copy against:
// out[0..3] = kCluster, kMaxStrip, kMaxStage, kMaxEntries. Returns 0.
extern "C" int wipa_sr_quant_geometry(int* out) {
  out[0] = kCluster;
  out[1] = kMaxStrip;
  out[2] = kMaxStage;
  out[3] = kMaxEntries;
  return 0;
}
