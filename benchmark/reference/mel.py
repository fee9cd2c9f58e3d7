"""Whisper's log-mel frontend (openai/whisper ``audio.py``), in float64.

16 kHz audio, a 400-point periodic Hann window, hop 160, reflect padding
of 200 on each side (``torch.stft(center=True)``), the last frame dropped,
|STFT|^2, a Slaney-normalised mel filterbank (librosa's default, 0-8 kHz),
log10 clamped at 1e-10, each window clamped to its max - 8, then
(x + 4) / 4. Returns (B, n_samples // 160, n_mels) float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_FFT, HOP = 400, 160
SAMPLE_RATE = 16000


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int) -> np.ndarray:
    """(n_mels, 201) Slaney-normalised triangular filters, float64."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2)
    hz = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, n) waveform -> (B, n // 160, n_mels) float32 log-mel."""
    x = audio.to(torch.float64)
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                               device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2  # (B, 201, frames)
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(x.device)
    mel = torch.einsum("mf,bft->btm", fb, power)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return ((log_spec + 4.0) / 4.0).to(torch.float32)
