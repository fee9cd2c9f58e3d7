"""Log-mel frontend: the K1 kernel (``csrc/mel.cu``) and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/mel_kernel.log_mel_spectrogram_pallas``.
The numerical contract is the Whisper frontend of ``audio/mel.py``
(16 kHz, N_FFT 400, hop 160, periodic Hann, reflect padding, final frame
dropped, Slaney mel filterbank, log10 clamp at 1e-10, then max-8 and
(x+4)/4). As in the JAX package, the reflect padding and the global clamp
and normalisation stay outside the kernel; the kernel computes the per-frame
``log10(max(mel, 1e-10))``.

The plain version's operators are ``audio.mel._dft_mel_operators``
(NumPy): the Hann window folded into (400, 201) cos/sin bases and the
(201, n_mels) filterbank. The kernel's are ``fft_operators``: the window,
the 20-point DFT's roots of unity and the twiddles of the 400 = 20 * 20
split, each computed in float64 and rounded once to f32, and each mel
filter's nonzero bin range.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import HOP_LENGTH, N_FFT, _dft_mel_operators, _hann_periodic
from . import _build
from .precision import full_fp32

FFT_RADIX = 20  # N_FFT = 20 * 20: the kernel's two stages of 20-point DFTs
FFT_HALF = FFT_RADIX // 2 + 1  # stage-1 outputs the kernel keeps (real input)


class MelOperators(NamedTuple):
    cos_b: torch.Tensor      # (400, 201) Hann-folded cos basis (plain version)
    sin_b: torch.Tensor      # (400, 201) Hann-folded sin basis (plain version)
    mel_t: torch.Tensor      # (201, n_mels) filterbank
    window: torch.Tensor     # (400,) periodic Hann
    w20: torch.Tensor        # (2, 20) cos, sin of 2 pi j / 20
    twiddle: torch.Tensor    # (2, 20, 11) cos, sin of 2 pi n2 k1 / 400
    mel_range: torch.Tensor  # (n_mels, 2) int32 first, one-past-last nonzero bin


def fft_operators(n_mels: int):
    """The kernel's constants as NumPy arrays: (window, w20, twiddle,
    mel_range), each float computed in float64 and rounded once to f32."""
    j = np.arange(FFT_RADIX, dtype=np.float64)
    w20 = np.stack([np.cos(2 * np.pi * j / FFT_RADIX),
                    np.sin(2 * np.pi * j / FFT_RADIX)]).astype(np.float32)
    ang = 2 * np.pi * np.outer(j, np.arange(FFT_HALF)) / N_FFT
    twiddle = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    window = _hann_periodic().astype(np.float32)
    mel_t = _dft_mel_operators(n_mels)[2]
    nonzero = mel_t != 0.0
    lo = np.argmax(nonzero, axis=0)
    hi = mel_t.shape[0] - np.argmax(nonzero[::-1], axis=0)
    mel_range = np.stack([lo, hi], axis=1).astype(np.int32)
    return window, w20, twiddle, mel_range


@lru_cache(maxsize=8)
def _operators(n_mels: int, device: torch.device) -> MelOperators:
    arrays = (*_dft_mel_operators(n_mels), *fft_operators(n_mels))
    return MelOperators(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
    ))


def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, n + N_FFT): reflect padding by N_FFT // 2 each side."""
    pad = N_FFT // 2
    return F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]


def log_mel_power_plain(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Plain PyTorch K1: the torch form of ``log_mel_spectrogram_jax``'s
    per-frame part, at full fp32 (no TF32).

    padded: (B, n + N_FFT) f32 -> (B, n // HOP, n_mels) log10 mel power.
    """
    cos_b, sin_b, mel_t = _operators(n_mels, padded.device)[:3]
    n_frames = (padded.shape[-1] - N_FFT) // HOP_LENGTH
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    with full_fp32():
        re = frames @ cos_b
        im = frames @ sin_b
        mel = (re * re + im * im) @ mel_t
    return torch.log10(torch.clamp_min(mel, 1e-10))


def log_mel_power(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """K1 wrapper: CUDA tensors run ``csrc/mel.cu``, CPU tensors the plain
    version. padded: (B, n + N_FFT) f32 contiguous."""
    if padded.dim() != 2 or padded.dtype != torch.float32:
        raise ValueError(
            f"log_mel_power wants (B, samples) float32, got "
            f"{tuple(padded.shape)} {padded.dtype}"
        )
    if n_mels not in (80, 128):
        raise ValueError(f"n_mels must be 80 or 128, got {n_mels}")
    if padded.device.type == "cpu":
        return log_mel_power_plain(padded, n_mels)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    if not padded.is_contiguous():
        raise ValueError("log_mel_power wants a contiguous waveform")
    if padded.shape[-1] < N_FFT + HOP_LENGTH:
        raise ValueError("waveform shorter than one hop")

    fn = _build.entry(
        "mel",
        "wipa_log_mel_power",
        [_build.P, _build.I, _build.I, _build.I] + [_build.P] * 5
        + [_build.I, _build.P, _build.I, _build.P],
    )
    ops = _operators(n_mels, padded.device)
    B, padded_len = padded.shape
    n_frames = (padded_len - N_FFT) // HOP_LENGTH
    out = torch.empty(
        (B, n_frames, n_mels), dtype=torch.float32, device=padded.device
    )
    rc = fn(
        padded.data_ptr(), B, padded_len, n_frames, ops.window.data_ptr(),
        ops.w20.data_ptr(), ops.twiddle.data_ptr(), ops.mel_t.data_ptr(),
        ops.mel_range.data_ptr(), n_mels, out.data_ptr(), padded.device.index,
        torch.cuda.current_stream(padded.device).cuda_stream,
    )
    _build.check(rc, "wipa_log_mel_power")
    log_mel_power.launches += 1
    return out


log_mel_power.launches = 0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, n_samples) or (n_samples,) f32 waveform -> (..., n_samples // 160,
    n_mels) Whisper log-mel, on the waveform's device (K1 on CUDA)."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    log_spec = normalize(log_mel_power(reflect_pad(audio).contiguous(), n_mels))
    return log_spec[0] if squeeze else log_spec


def normalize(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's per-utterance dynamic-range clamp (max - 8) and (x+4)/4."""
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0
