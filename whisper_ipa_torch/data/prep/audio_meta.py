"""Dependency-free audio duration probing (MP3 frame headers, WAV).

Replaces the reference's mutagen MP3-header probe
(reference create_dataset_scripts/preprocess_local.py:110-117): reads only
headers, never decodes. Supports CBR and Xing/Info VBR MP3 and PCM WAV.
"""

from __future__ import annotations

import struct
import wave
from typing import Optional

_BITRATES_V1_L3 = [
    0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0
]
_BITRATES_V2_L3 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0]
_SAMPLE_RATES = {
    3: [44100, 48000, 32000],  # MPEG1
    2: [22050, 24000, 16000],  # MPEG2
    0: [11025, 12000, 8000],  # MPEG2.5
}


def _mp3_duration(path: str) -> Optional[float]:
    with open(path, "rb") as f:
        data = f.read(256 * 1024)
        import os

        file_size = os.fstat(f.fileno()).st_size

    # skip ID3v2 tag
    offset = 0
    if data[:3] == b"ID3":
        size = (
            (data[6] & 0x7F) << 21
            | (data[7] & 0x7F) << 14
            | (data[8] & 0x7F) << 7
            | (data[9] & 0x7F)
        )
        offset = 10 + size

    # find first frame sync
    i = offset
    while i < len(data) - 4:
        if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
            b1, b2 = data[i + 1], data[i + 2]
            version = (b1 >> 3) & 0x3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
            layer = (b1 >> 1) & 0x3  # 1=Layer3
            if version == 1 or layer != 1:
                i += 1
                continue
            bitrate_idx = (b2 >> 4) & 0xF
            sr_idx = (b2 >> 2) & 0x3
            if sr_idx == 3 or bitrate_idx in (0, 15):
                i += 1
                continue
            sample_rate = _SAMPLE_RATES[version][sr_idx]
            bitrates = _BITRATES_V1_L3 if version == 3 else _BITRATES_V2_L3
            bitrate = bitrates[bitrate_idx] * 1000
            samples_per_frame = 1152 if version == 3 else 576

            # Xing/Info header (VBR): frame count
            xing_off = i + 4 + (32 if version == 3 else 17) + 2
            for probe in (i + 36, i + 21, i + 13, xing_off):
                if probe + 16 <= len(data) and data[probe : probe + 4] in (
                    b"Xing",
                    b"Info",
                ):
                    flags = struct.unpack(
                        ">I", data[probe + 4 : probe + 8]
                    )[0]
                    if flags & 1:
                        n_frames = struct.unpack(
                            ">I", data[probe + 8 : probe + 12]
                        )[0]
                        return n_frames * samples_per_frame / sample_rate
            # CBR estimate
            if bitrate > 0:
                return (file_size - i) * 8.0 / bitrate
            return None
        i += 1
    return None


def get_audio_duration(path: str) -> Optional[float]:
    """Duration in seconds from headers only; None if unreadable."""
    lower = path.lower()
    try:
        if lower.endswith(".wav"):
            with wave.open(path, "rb") as w:
                return w.getnframes() / float(w.getframerate())
        if lower.endswith(".mp3"):
            return _mp3_duration(path)
    except Exception:
        return None
    return None
