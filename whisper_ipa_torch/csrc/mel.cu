// Fused log-mel power spectrum for Hopper (sm_90a).
//
// Replaces: whisper_ipa_tpu/ops/mel_kernel.py, log_mel_spectrogram_pallas
// (pallas_call at :155, body _mel_block_kernel :79).
//
// Computes, for each frame i of a reflect-padded 16 kHz waveform,
//   log10(max(mel_t^T |DFT_400(hann * x_i)|^2, 1e-10))
// with x_i = padded[i*160 : i*160+400], the power spectrum's 201 bins and
// the (201, n_mels) Slaney filterbank. The global max-8 clamp and (x+4)/4
// stay in PyTorch.
//
// What bounds it on the H100: fp32 arithmetic. Every operation is a plain
// fp32 FMA on the CUDA cores: the tensor cores' TF32 keeps ~3 digits, and
// the power spectrum feeds a log10 over 8 decades.
//
// Design: the 400-point DFT as two stages of 20-point DFTs (Cooley-Tukey,
// n = 20 n1 + n2, k = k1 + 20 k2) with a twiddle multiply between them,
// ~27k FMAs a frame where the direct DFT takes ~161k; the mel product
// sums only each filter's contiguous nonzero bins, in bin order (391 of
// 16080 weights at 80 mels), so every sum equals the dense one in the same
// order. One block of 10 warps per (32-frame tile, batch row); lane l owns
// frame l in every stage, the warps split the stage's other index:
//   0. the tile's samples land in shared memory as hop rows of 160, padded
//      to 161 floats, so 32 frames 160 samples apart hit 32 banks;
//   1. for each n2 (two a warp), the 20-point DFT over n1 of hann * x, the
//      Hann window applied as each sample is read: only k1 = 0..10 (real
//      input: the rest are their conjugates), times W400^(n2 k1);
//   2. for k1 = p in 1..9 a warp takes bins p + 20 k2 and, from the same
//      inputs, 20 - p + 20 k2 (Z'[n2][20-p] = conj(Z'[n2][p]) W20^n2); the
//      last warp takes k1 = 0 (bins 0, 20, .., 200) and k1 = 10: bins 0..200
//      and no more. |X|^2 goes to shared memory, where the samples were;
//   3. each warp takes every 10th mel filter over its nonzero bins, then
//      log10; the tile's (frame, mel) rows go out as one coalesced store.
// The 20th roots of unity live in registers (the stages are unrolled, so
// every index into them is a constant); they, the window and the twiddles
// are computed in float64 on the host and rounded once to f32.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = 201;       // N_FFT / 2 + 1
constexpr int kR = 20;           // 400 = 20 * 20
constexpr int kHalf = 11;        // stage-1 outputs kept: k1 = 0..10
constexpr int kTile = 32;        // frames a block: one a lane
constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowStride = kHop + 1;  // a hop row of samples in shared memory
constexpr int kRows = (kTile * kHop + kNFFT - kHop + kHop - 1) / kHop;  // 34
constexpr int kXFloats = kRows * kRowStride;
constexpr int kPowFloats = kBins * kTile;
constexpr int kAFloats = kXFloats > kPowFloats ? kXFloats : kPowFloats;
constexpr int kZFloats = kR * kHalf * kTile;  // one plane of stage 1's outputs
constexpr size_t kSmemBytes = sizeof(float) * (kAFloats + 2 * kZFloats);

static_assert(kPowFloats >= kXFloats, "power spectrum overlays the samples");
static_assert(kTile * 129 <= kZFloats, "the log-mel tile overlays stage 1's outputs");

// cos and sin of 2 pi j / 20 from the registers of j = 0..10
__device__ __forceinline__ float cos20(const float (&c)[kHalf], int j) {
  return j <= 10 ? c[j] : c[kR - j];
}
__device__ __forceinline__ float sin20(const float (&s)[kHalf], int j) {
  return j <= 10 ? s[j] : -s[kR - j];
}

// w20: cos, then sin, of 2 pi j / 20 (j < 20); twiddle: cos, then sin, of
// 2 pi n2 k1 / 400 as (20, 11); window: the periodic Hann window (400);
// mel_range: (n_mels, 2) first and one-past-last nonzero bin of a filter.
__global__ void __launch_bounds__(kThreads, 2)
log_mel_fft_kernel(const float* __restrict__ audio, int padded_len, int n_frames,
                   const float* __restrict__ window, const float* __restrict__ w20,
                   const float* __restrict__ twiddle, const float* __restrict__ mel_t,
                   const int* __restrict__ mel_range, int n_mels,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;             // hop rows of samples, then |X|^2 as (bin, frame)
  float* pw = smem;
  float* zr = smem + kAFloats;  // stage 1's outputs as (n2, k1, frame)
  float* zi = zr + kZFloats;
  float* os = zr;               // the log-mel tile as (frame, mel), padded

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* row = audio + static_cast<size_t>(b) * padded_len;
  const long s0 = static_cast<long>(f0) * kHop;

  float c[kHalf], s[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    c[j] = __ldg(w20 + j);
    s[j] = __ldg(w20 + kR + j);
  }

  // 0. samples: tile offset i at xs[i + i / 160]
  for (int i = threadIdx.x; i < kRows * kHop; i += kThreads) {
    const long g = s0 + i;
    xs[i + i / kHop] = g < padded_len ? __ldg(row + g) : 0.0f;
  }
  __syncthreads();

  // 1. Z'[n2][k1] = W400^(n2 k1) sum_n1 hann[n] x[n] W20^(n1 k1), n = 20 n1 + n2
  for (int n2 = warp; n2 < kR; n2 += kWarps) {
    float re[kHalf], im[kHalf];
#pragma unroll
    for (int k1 = 0; k1 < kHalf; ++k1) {
      re[k1] = 0.0f;
      im[k1] = 0.0f;
    }
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) {
      const int n = kR * n1 + n2;
      // frame `lane`'s sample n: tile offset 160 lane + n
      const float y = xs[lane * kRowStride + n + (n >= kHop) + (n >= 2 * kHop)] *
                      __ldg(window + n);
#pragma unroll
      for (int k1 = 0; k1 < kHalf; ++k1) {
        const int j = (n1 * k1) % kR;
        re[k1] = fmaf(y, cos20(c, j), re[k1]);
        im[k1] = fmaf(-y, sin20(s, j), im[k1]);
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < kHalf; ++k1) {
      const float tc = __ldg(twiddle + n2 * kHalf + k1);
      const float ts = __ldg(twiddle + kR * kHalf + n2 * kHalf + k1);
      const int z = (n2 * kHalf + k1) * kTile + lane;
      zr[z] = fmaf(re[k1], tc, im[k1] * ts);   // (re + i im)(tc - i ts)
      zi[z] = fmaf(im[k1], tc, -re[k1] * ts);
    }
  }
  __syncthreads();

  // 2. X[k1 + 20 k2] = sum_n2 Z'[n2][k1] W20^(n2 k2), bins 0..200
  if (warp < 9) {
    const int p = warp + 1;
    float dr[10], di[10], mr[10], mi[10];  // bins p + 20 k2 and 20 - p + 20 k2
#pragma unroll
    for (int k2 = 0; k2 < 10; ++k2) {
      dr[k2] = 0.0f;
      di[k2] = 0.0f;
      mr[k2] = 0.0f;
      mi[k2] = 0.0f;
    }
#pragma unroll
    for (int n2 = 0; n2 < kR; ++n2) {
      const float a = zr[(n2 * kHalf + p) * kTile + lane];
      const float bb = zi[(n2 * kHalf + p) * kTile + lane];
#pragma unroll
      for (int k2 = 0; k2 < 10; ++k2) {
        const int j = (n2 * k2) % kR;          // (a + i b) W20^j
        const int jm = (n2 * (k2 + 1)) % kR;   // (a - i b) W20^jm
        dr[k2] = fmaf(bb, sin20(s, j), fmaf(a, cos20(c, j), dr[k2]));
        di[k2] = fmaf(-a, sin20(s, j), fmaf(bb, cos20(c, j), di[k2]));
        mr[k2] = fmaf(-bb, sin20(s, jm), fmaf(a, cos20(c, jm), mr[k2]));
        mi[k2] = fmaf(-a, sin20(s, jm), fmaf(-bb, cos20(c, jm), mi[k2]));
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < 10; ++k2) {
      pw[(p + kR * k2) * kTile + lane] = dr[k2] * dr[k2] + di[k2] * di[k2];
      pw[(kR - p + kR * k2) * kTile + lane] = mr[k2] * mr[k2] + mi[k2] * mi[k2];
    }
  } else {
    // k1 = 0, whose Z' is real, and k1 = 10
    float r0[11], i0[11], r10[10], i10[10];
#pragma unroll
    for (int k2 = 0; k2 < 11; ++k2) {
      r0[k2] = 0.0f;
      i0[k2] = 0.0f;
      if (k2 < 10) {
        r10[k2] = 0.0f;
        i10[k2] = 0.0f;
      }
    }
#pragma unroll
    for (int n2 = 0; n2 < kR; ++n2) {
      const float a0 = zr[(n2 * kHalf) * kTile + lane];
      const float a = zr[(n2 * kHalf + 10) * kTile + lane];
      const float bb = zi[(n2 * kHalf + 10) * kTile + lane];
#pragma unroll
      for (int k2 = 0; k2 < 11; ++k2) {
        const int j = (n2 * k2) % kR;
        r0[k2] = fmaf(a0, cos20(c, j), r0[k2]);
        i0[k2] = fmaf(-a0, sin20(s, j), i0[k2]);
        if (k2 < 10) {
          r10[k2] = fmaf(bb, sin20(s, j), fmaf(a, cos20(c, j), r10[k2]));
          i10[k2] = fmaf(-a, sin20(s, j), fmaf(bb, cos20(c, j), i10[k2]));
        }
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < 11; ++k2) {
      pw[(kR * k2) * kTile + lane] = r0[k2] * r0[k2] + i0[k2] * i0[k2];
      if (k2 < 10) {
        pw[(10 + kR * k2) * kTile + lane] = r10[k2] * r10[k2] + i10[k2] * i10[k2];
      }
    }
  }
  __syncthreads();

  // 3. each filter over its nonzero bins, in bin order, then the log10 clamp
  const int os_stride = n_mels + 1;
  for (int m = warp; m < n_mels; m += kWarps) {
    const int lo = __ldg(mel_range + 2 * m);
    const int hi = __ldg(mel_range + 2 * m + 1);
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) {
      acc = fmaf(pw[k * kTile + lane], __ldg(mel_t + k * n_mels + m), acc);
    }
    os[lane * os_stride + m] = log10f(fmaxf(acc, 1e-10f));
  }
  __syncthreads();

  // 4. the tile's frames are consecutive rows of out
  const int frames = min(kTile, n_frames - f0);
  float* dst = out + (static_cast<size_t>(b) * n_frames + f0) * n_mels;
  for (int i = threadIdx.x; i < frames * n_mels; i += kThreads) {
    const int f = i / n_mels;
    dst[i] = os[f * os_stride + (i - f * n_mels)];
  }
}

}  // namespace

// audio: (batch, padded_len) f32, reflect-padded by N_FFT/2 on both sides;
// window (400), w20 (2, 20), twiddle (2, 20, 11), mel_t (201, n_mels) f32;
// mel_range (n_mels, 2) int32; out: (batch, n_frames, n_mels) f32; n_mels
// at most 128. Returns cudaGetLastError().
extern "C" int wipa_log_mel_power(const void* audio, int batch, int padded_len,
                                  int n_frames, const void* window, const void* w20,
                                  const void* twiddle, const void* mel_t,
                                  const void* mel_range, int n_mels, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_frames <= 0 || n_mels <= 0 || n_mels > 128 ||
      padded_len < (n_frames - 1) * kHop + kNFFT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(log_mel_fft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  log_mel_fft_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), padded_len, n_frames,
      static_cast<const float*>(window), static_cast<const float*>(w20),
      static_cast<const float*>(twiddle), static_cast<const float*>(mel_t),
      static_cast<const int*>(mel_range), n_mels, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
