"""Host audio: WAV decode, resample, pad/trim, and the NumPy log-mel
(copies of ``whisper_ipa_tpu.audio``'s NumPy parts)."""

from .io import (
    CHUNK_LENGTH,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    load_audio_bytes,
    pad_or_trim,
    resample,
    write_wav,
)
from .mel import HOP_LENGTH, N_FFT, N_FRAMES, log_mel_spectrogram, mel_filters

__all__ = [
    "CHUNK_LENGTH",
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES",
    "N_SAMPLES",
    "SAMPLE_RATE",
    "load_audio",
    "load_audio_bytes",
    "log_mel_spectrogram",
    "mel_filters",
    "pad_or_trim",
    "resample",
    "write_wav",
]
