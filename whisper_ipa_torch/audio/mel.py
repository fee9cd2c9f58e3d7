"""Whisper-exact log-mel spectrogram: the NumPy reference and DFT operators.

The PyTorch package's copy of the NumPy half of
``whisper_ipa_tpu/audio/mel.py`` (the JAX path is not copied; the port's
device frontend is ``ops/mel_kernel.py``). Numerical contract:

  - 16 kHz audio, N_FFT=400, HOP=160, periodic Hann window
  - reflect-padding by N_FFT//2 on both sides (center=True), the final
    frame dropped -> 3000 frames for a 30 s window
  - power spectrum |rfft|^2 (201 bins)
  - Slaney-style mel filterbank (librosa default), fmax = 8 kHz, 80 or 128
    mels
  - log10 with 1e-10 clamp, dynamic-range compression to max-8, then
    (x + 4) / 4
  - output layout (n_frames, n_mels): frames-first, as the encoder consumes
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_FRAMES = 3000  # 30 s / 10 ms


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney-style Hz->mel (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = f / f_sp
    above = f >= min_log_hz
    mels = np.where(
        above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )
    return mels


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = m * f_sp
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@lru_cache(maxsize=8)
def mel_filters(
    n_mels: int = 80,
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_pts = np.linspace(
        hz_to_mel_slaney(np.array(fmin)), hz_to_mel_slaney(np.array(fmax)), n_mels + 2
    )
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_periodic(n: int = N_FFT) -> np.ndarray:
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(
        np.float64
    )


def log_mel_spectrogram(
    audio: np.ndarray, n_mels: int = 80, padding: int = 0
) -> np.ndarray:
    """NumPy reference implementation. Returns (n_frames, n_mels) float32."""
    audio = np.asarray(audio, dtype=np.float64)
    if padding > 0:
        audio = np.pad(audio, (0, padding))
    pad = N_FFT // 2
    audio = np.pad(audio, (pad, pad), mode="reflect")

    n_frames = 1 + (len(audio) - N_FFT) // HOP_LENGTH
    idx = (
        np.arange(N_FFT)[None, :]
        + HOP_LENGTH * np.arange(n_frames)[:, None]
    )
    frames = audio[idx] * _hann_periodic()[None, :]
    stft = np.fft.rfft(frames, axis=-1)
    magnitudes = np.abs(stft[:-1]) ** 2  # drop the final frame

    mel = magnitudes @ mel_filters(n_mels).T.astype(np.float64)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_mel_operators(n_mels: int):
    """Precompute (windowed DFT bases, mel matrix) as float32 arrays.

    cos_b/sin_b fold the Hann window into the DFT basis, so the frontend
    is: frames @ cos_b, frames @ sin_b -> power -> @ mel.T.
    """
    k = np.arange(N_FFT // 2 + 1)[None, :]
    n = np.arange(N_FFT)[:, None]
    ang = -2.0 * np.pi * n * k / N_FFT
    win = _hann_periodic()[:, None]
    cos_b = (np.cos(ang) * win).astype(np.float32)
    sin_b = (np.sin(ang) * win).astype(np.float32)
    melT = mel_filters(n_mels).T.astype(np.float32)  # (201, n_mels)
    return cos_b, sin_b, melT
