// Fused log-mel power spectrum for Hopper (sm_90a).
//
// Replaces: whisper_ipa_tpu/ops/mel_kernel.py, log_mel_spectrogram_pallas
// (pallas_call at :155, body _mel_block_kernel :79).
//
// Computes, for each frame i of a reflect-padded 16 kHz waveform,
//   log10(max(mel_t^T ((x_i cos_b)^2 + (x_i sin_b)^2), 1e-10))
// with x_i = padded[i*160 : i*160+400] and cos_b/sin_b the Hann-folded DFT
// bases (400 x 201). The global max-8 clamp and (x+4)/4 stay in PyTorch.
//
// What bounds it on the H100: fp32 arithmetic. The DFT is ~161k FMAs per
// frame (400 samples x 201 bins x cos/sin), ~3.9 GFMA for a batch of 8
// 30 s windows, against 0.5 MB of input; the tensor cores are not an
// option because the power spectrum feeds a log10 over 8 decades and TF32
// loses ~3 digits, so every product is a plain fp32 FMA.
//
// Design: one block per (32-frame tile, batch row). The tile's samples
// (32 hops + 240 = 5360 floats) are loaded once into shared memory with
// coalesced reads, instead of each thread gathering 400-sample frames
// from device memory. 416 threads = 2 frame halves x 208 bin lanes (201
// live); a thread keeps 16 frames' (re, im) accumulators in registers,
// reads each basis value once per tile from L2 (coalesced over bins) and
// the samples as shared-memory broadcasts. The power spectrum then stays
// in shared memory for the dense mel product and the log10.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = 201;          // N_FFT / 2 + 1
constexpr int kBinLanes = 208;      // bins rounded up to whole lanes
constexpr int kTile = 32;           // frames per block
constexpr int kHalves = 2;          // frame halves per block
constexpr int kFramesPerThread = kTile / kHalves;
constexpr int kThreads = kBinLanes * kHalves;  // 416
constexpr int kTileSamples = kTile * kHop + (kNFFT - kHop);  // 5360

__global__ void __launch_bounds__(kThreads)
log_mel_power_kernel(const float* __restrict__ audio, int padded_len,
                     int n_frames, const float* __restrict__ cos_b,
                     const float* __restrict__ sin_b,
                     const float* __restrict__ mel_t, int n_mels,
                     float* __restrict__ out) {
  __shared__ float samples[kTileSamples];
  __shared__ float power[kTile * kBins];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const float* row = audio + static_cast<size_t>(b) * padded_len;
  const long s0 = static_cast<long>(f0) * kHop;

  for (int i = threadIdx.x; i < kTileSamples; i += kThreads) {
    const long s = s0 + i;
    samples[i] = s < padded_len ? row[s] : 0.0f;
  }
  __syncthreads();

  const int k = threadIdx.x % kBinLanes;
  const int half = threadIdx.x / kBinLanes;
  if (k < kBins) {
    float re[kFramesPerThread];
    float im[kFramesPerThread];
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    const float* x = samples + half * kFramesPerThread * kHop;
    for (int n = 0; n < kNFFT; ++n) {
      const float c = __ldg(cos_b + n * kBins + k);
      const float s = __ldg(sin_b + n * kBins + k);
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) {
        const float xv = x[f * kHop + n];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
      const int fl = half * kFramesPerThread + f;
      power[fl * kBins + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  float* out_b = out + static_cast<size_t>(b) * n_frames * n_mels;
  for (int idx = threadIdx.x; idx < kTile * n_mels; idx += kThreads) {
    const int fl = idx / n_mels;
    const int m = idx - fl * n_mels;
    const int frame = f0 + fl;
    if (frame >= n_frames) continue;
    const float* p = power + fl * kBins;
    float acc = 0.0f;
    for (int kk = 0; kk < kBins; ++kk) {
      acc = fmaf(p[kk], __ldg(mel_t + kk * n_mels + m), acc);
    }
    out_b[static_cast<size_t>(frame) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio: (batch, padded_len) f32, reflect-padded by N_FFT/2 on both sides;
// cos_b/sin_b: (400, 201) f32; mel_t: (201, n_mels) f32;
// out: (batch, n_frames, n_mels) f32. Returns cudaGetLastError().
extern "C" int wipa_log_mel_power(const void* audio, int batch, int padded_len,
                                  int n_frames, const void* cos_b,
                                  const void* sin_b, const void* mel_t,
                                  int n_mels, void* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  log_mel_power_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), padded_len, n_frames,
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      static_cast<const float*>(mel_t), n_mels, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
