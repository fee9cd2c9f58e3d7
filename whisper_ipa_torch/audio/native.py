"""ctypes binding for the native WAV decoder (native/audio.cpp).

The PyTorch package's copy of ``whisper_ipa_tpu/audio/native.py``. Raises
on import when the shared library is missing; audio/io.py catches that and
uses the Python decoder.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..metrics.native import _find_library  # same shared library

_lib = ctypes.CDLL(_find_library())
_lib.wipa_decode_wav.restype = ctypes.c_int64
_lib.wipa_decode_wav.argtypes = [
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_int64,
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_float),
    ctypes.c_int64,
]


def decode_wav_bytes(data: bytes, target_sr: int = 16000) -> np.ndarray:
    """WAV bytes -> mono float32 at target_sr. Raises ValueError on parse
    failure."""
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    n = _lib.wipa_decode_wav(buf, len(data), target_sr, None, 0)
    if n < 0:
        raise ValueError("native WAV parse failed")
    out = np.empty(n, np.float32)
    got = _lib.wipa_decode_wav(
        buf,
        len(data),
        target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got != n:
        raise ValueError("native WAV decode failed")
    return out


def decode_wav_file(path: str, target_sr: int = 16000) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_wav_bytes(f.read(), target_sr)
