"""Host-side audio IO: decode + resample to 16 kHz mono float32.

The reference shells out to ffmpeg for every file
(mlx_whisper.audio.load_audio, consumed at reference
scripts/ipa_data_loader.py:48). Here WAV/PCM decoding is done in-process
(stdlib + NumPy) with polyphase resampling (scipy); ffmpeg is only used as
an optional fallback for compressed formats (mp3/flac/ogg) when present.

The PyTorch package's copy of ``whisper_ipa_tpu/audio/io.py``: WAV files
take the native C++ decoder (``audio.native``) when its library is built,
and the Python decoder (the same samples) otherwise.
"""

from __future__ import annotations

import io
import shutil
import subprocess
import wave
import numpy as np

SAMPLE_RATE = 16000
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000


def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a PCM/float WAV file to float32 in [-1, 1]."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        raw = w.readframes(w.getnframes())

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        data = i32.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, framerate


def _decode_with_scipy(path: str) -> tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def _decode_with_ffmpeg(path: str, sr: int) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and ffmpeg is not "
            "installed (compressed formats require ffmpeg on PATH)"
        )
    cmd = [
        ffmpeg, "-nostdin", "-threads", "0", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
        "-ar", str(sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling to target_sr."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


try:  # native C++ decoder (native/audio.cpp); Python path is the fallback
    from .native import decode_wav_file as _native_decode_wav
except Exception:  # pragma: no cover - shared library not built
    _native_decode_wav = None


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file as 16 kHz mono float32."""
    lower = path.lower()
    if lower.endswith(".wav"):
        if _native_decode_wav is not None:
            try:
                return _native_decode_wav(path, sr)
            except Exception:
                pass  # malformed/exotic WAV: fall through to Python
        try:
            data, orig_sr = _decode_wav(path)
        except Exception:
            data, orig_sr = _decode_with_scipy(path)
        return resample(data, orig_sr, sr)
    return _decode_with_ffmpeg(path, sr)


def load_audio_bytes(raw: bytes, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Decode in-memory WAV bytes (e.g. synthesized fixtures)."""
    with wave.open(io.BytesIO(raw), "rb") as w:
        n_channels = w.getnchannels()
        framerate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    audio = data.astype(np.float32) / 32768.0
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    return resample(audio, framerate, sr)


def pad_or_trim(
    audio: np.ndarray, length: int = N_SAMPLES, axis: int = -1
) -> np.ndarray:
    """Pad with zeros or trim to exactly `length` samples (30 s window)."""
    if audio.shape[axis] > length:
        sl = [slice(None)] * audio.ndim
        sl[axis] = slice(0, length)
        return audio[tuple(sl)]
    if audio.shape[axis] < length:
        pad = [(0, 0)] * audio.ndim
        pad[axis] = (0, length - audio.shape[axis])
        return np.pad(audio, pad)
    return audio


def write_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write mono float32 [-1, 1] audio as 16-bit PCM WAV (test fixtures)."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
