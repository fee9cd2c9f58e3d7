"""Phoneme-controlled synthetic speech (formant synthesis, no deps).

The reference fabricated pronunciation-variant test audio with Piper
TTS + ONNX (reference scripts/experimental/test_piper*.py — e.g. swapping a
flap for /t/ to test whether models hear the difference). This module gives
the same capability without any TTS dependency: a small formant synthesizer
driven directly by IPA phone sequences. It is NOT natural speech — it is a
deterministic, controllable acoustic realization where each phone has a
distinct spectral signature, which is exactly what fixture generation and
pronunciation-substitution experiments need.

  - vowels/sonorants: pulse-train glottal source through three cascaded
    second-order resonators at standard formant frequencies
  - fricatives: shaped noise (place-specific spectral center)
  - stops: closure silence + release burst (+ voicing murmur when voiced)
  - diacritics: length (ː doubles duration), nasalization (adds a low
    murmur), syllabics/devoicing handled via the feature table

The PyTorch package's copy of ``whisper_ipa_tpu/data/synth.py`` (NumPy and
SciPy only): the same seed gives the same waveform bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..metrics.segment import tokenize_ipa

SAMPLE_RATE = 16000

# F1, F2, F3 (Hz) for vowels
_VOWEL_FORMANTS: Dict[str, Tuple[float, float, float]] = {
    "i": (270, 2290, 3010), "y": (270, 2100, 2600),
    "ɨ": (300, 1600, 2500), "ʉ": (320, 1500, 2400),
    "ɯ": (300, 1300, 2300), "u": (300, 870, 2240),
    "ɪ": (390, 1990, 2550), "ʏ": (400, 1850, 2500),
    "ʊ": (440, 1020, 2240),
    "e": (460, 2200, 2800), "ø": (460, 1700, 2500),
    "ɘ": (490, 1600, 2500), "ɵ": (490, 1400, 2400),
    "ɤ": (460, 1200, 2400), "o": (450, 800, 2830),
    "ə": (500, 1500, 2500),
    "ɛ": (530, 1840, 2480), "œ": (530, 1600, 2400),
    "ɜ": (560, 1600, 2500), "ɞ": (560, 1400, 2400),
    "ʌ": (640, 1190, 2390), "ɔ": (570, 840, 2410),
    "æ": (660, 1720, 2410), "ɐ": (680, 1400, 2400),
    "a": (730, 1090, 2440), "ɶ": (730, 1200, 2400),
    "ɑ": (730, 1090, 2440), "ɒ": (700, 900, 2400),
    "ɚ": (490, 1350, 1690), "ɝ": (490, 1350, 1690),
}

# sonorant consonants: approximate formant targets
_SONORANT_FORMANTS: Dict[str, Tuple[float, float, float]] = {
    "m": (250, 1000, 2200), "n": (250, 1500, 2500), "ŋ": (250, 1200, 2300),
    "ɲ": (250, 1800, 2700), "ɳ": (250, 1400, 2300), "ɴ": (250, 1100, 2200),
    "l": (360, 1300, 2700), "ɫ": (360, 900, 2600), "ɭ": (360, 1200, 2500),
    "ʎ": (360, 1900, 2800), "r": (330, 1300, 2000), "ɾ": (330, 1300, 2000),
    "ɹ": (330, 1200, 1600), "ɻ": (330, 1100, 1500), "ɽ": (330, 1200, 1800),
    "j": (270, 2200, 3000), "w": (300, 700, 2200), "ɥ": (280, 1900, 2500),
    "ɰ": (300, 1300, 2300), "ʋ": (280, 900, 2200), "ʙ": (280, 900, 2000),
    "ʀ": (330, 1100, 2000),
}

# fricatives: (noise center Hz, bandwidth Hz, voiced)
_FRICATIVES: Dict[str, Tuple[float, float, bool]] = {
    "s": (6300, 2000, False), "z": (6300, 2000, True),
    "ʃ": (3200, 1800, False), "ʒ": (3200, 1800, True),
    "ʂ": (2800, 1800, False), "ʐ": (2800, 1800, True),
    "ɕ": (4500, 2000, False), "ʑ": (4500, 2000, True),
    "f": (4500, 3500, False), "v": (4500, 3500, True),
    "θ": (5500, 3500, False), "ð": (5500, 3500, True),
    "ç": (3800, 2200, False), "ʝ": (3800, 2200, True),
    "x": (2400, 1800, False), "ɣ": (2400, 1800, True),
    "χ": (2000, 1500, False), "ʁ": (2000, 1500, True),
    "ħ": (1500, 1500, False), "ʕ": (1500, 1500, True),
    "h": (2000, 4000, False), "ɦ": (2000, 4000, True),
    "ɸ": (3500, 3000, False), "β": (3500, 3000, True),
    "ɬ": (4200, 2500, False), "ɮ": (4200, 2500, True),
    "ʍ": (1200, 2000, False),
}

# stops: (burst center Hz, voiced)
_STOPS: Dict[str, Tuple[float, bool]] = {
    "p": (800, False), "b": (800, True),
    "t": (4000, False), "d": (4000, True),
    "ʈ": (3400, False), "ɖ": (3400, True),
    "c": (3000, False), "ɟ": (3000, True),
    "k": (1800, False), "ɡ": (1800, True), "g": (1800, True),
    "q": (1400, False), "ɢ": (1400, True),
    "ʔ": (500, False),
    "ɓ": (800, True), "ɗ": (4000, True), "ɠ": (1800, True),
}


def _resonator(signal: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """Second-order IIR resonance (formant filter)."""
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    b = [1 - r]
    return lfilter(b, a, signal)


def _glottal_source(n: int, f0: float, sr: int, rng) -> np.ndarray:
    """Impulse-train source with mild jitter."""
    out = np.zeros(n)
    period = sr / f0
    pos = 0.0
    while pos < n:
        out[int(pos)] = 1.0
        pos += period * (1.0 + 0.01 * rng.standard_normal())
    # integrate twice for a -12 dB/oct source spectrum
    out = np.cumsum(out) - np.linspace(0, out.sum(), n)
    out -= out.mean()
    return out


def _bandnoise(n: int, center: float, bw: float, sr: int, rng) -> np.ndarray:
    noise = rng.standard_normal(n)
    center = min(center, sr / 2 - 200)
    return _resonator(noise, center, bw, sr)


def _formant_segment(
    n: int, formants, f0: float, sr: int, rng
) -> np.ndarray:
    src = _glottal_source(n, f0, sr, rng)
    out = np.zeros(n)
    for freq, bw, gain in zip(formants, (80.0, 90.0, 120.0), (1.0, 0.63, 0.32)):
        out += gain * _resonator(src, freq, bw, sr)
    return out


def _normalize(seg: np.ndarray, level: float) -> np.ndarray:
    peak = np.max(np.abs(seg)) or 1.0
    return seg * (level / peak)


def synthesize_phone(
    phone: str,
    duration: float = 0.12,
    f0: float = 120.0,
    sr: int = SAMPLE_RATE,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """One phone -> waveform segment."""
    rng = rng or np.random.default_rng(0)
    base = phone[0] if phone else ""
    long = "ː" in phone
    nasalized = "̃" in phone
    devoiced = "̥" in phone or "̊" in phone
    dur = duration * (1.8 if long else 1.0)
    n = int(dur * sr)

    if base in _VOWEL_FORMANTS:
        seg = _formant_segment(n, _VOWEL_FORMANTS[base], f0, sr, rng)
        if devoiced:
            seg = _bandnoise(n, 1500, 2500, sr, rng) * 0.4
        level = 0.5
    elif base in _SONORANT_FORMANTS:
        seg = _formant_segment(n, _SONORANT_FORMANTS[base], f0, sr, rng)
        level = 0.35
    elif base in _FRICATIVES:
        center, bw, voiced = _FRICATIVES[base]
        seg = _bandnoise(n, center, bw, sr, rng)
        if voiced and not devoiced:
            seg = seg * 0.7 + 0.3 * _formant_segment(
                n, (250, 1500, 2500), f0, sr, rng
            )
        level = 0.3
    elif base in _STOPS:
        center, voiced = _STOPS[base]
        closure = int(0.05 * sr)
        burst = int(0.02 * sr)
        tail = max(n - closure - burst, 0)
        seg = np.zeros(n)
        if voiced and not devoiced:
            seg[:closure] = 0.1 * _formant_segment(
                closure, (200, 1200, 2400), f0, sr, rng
            )
        b = _bandnoise(burst, center, 1500, sr, rng)
        seg[closure : closure + burst] = b * np.exp(
            -np.linspace(0, 5, burst)
        )
        del tail
        level = 0.4
    else:
        # unknown phone: quiet broadband noise so it is still audible
        seg = _bandnoise(n, 2000, 3000, sr, rng) * 0.1
        level = 0.1

    if nasalized:
        seg = seg * 0.75 + 0.25 * _formant_segment(
            n, (250, 1000, 2200), f0, sr, rng
        )

    seg = _normalize(seg, level)
    # 5 ms raised-cosine edges against clicks
    edge = max(int(0.005 * sr), 1)
    ramp = 0.5 * (1 - np.cos(np.linspace(0, np.pi, edge)))
    seg[:edge] *= ramp
    seg[-edge:] *= ramp[::-1]
    return seg.astype(np.float32)


def synthesize_phonemes_with_alignment(
    phones: Sequence[str],
    duration: float = 0.12,
    f0: float = 120.0,
    sr: int = SAMPLE_RATE,
    seed: int = 0,
) -> Tuple[np.ndarray, List[Tuple[str, float, float]]]:
    """Phone sequence -> (waveform, [(phone, start_sec, end_sec), ...]).

    The synthesizer CONSTRUCTS the audio phone-by-phone, so the true
    per-phone boundaries are known exactly — the ground-truth oracle for
    the cross-attention DTW timestamps (decode/word_timestamps.py),
    which otherwise have no accuracy reference (VERDICT r2 item 7).
    """
    rng = np.random.default_rng(seed)
    segs = []
    alignment: List[Tuple[str, float, float]] = []
    pos = 0
    for p in phones:
        seg = synthesize_phone(p, duration=duration, f0=f0, sr=sr, rng=rng)
        alignment.append((p, pos / sr, (pos + len(seg)) / sr))
        pos += len(seg)
        segs.append(seg)
    if not segs:
        return np.zeros(0, np.float32), []
    return np.concatenate(segs), alignment


def synthesize_phonemes(
    phones: Sequence[str],
    duration: float = 0.12,
    f0: float = 120.0,
    sr: int = SAMPLE_RATE,
    seed: int = 0,
) -> np.ndarray:
    """Phone sequence -> waveform (the Piper-experiment replacement)."""
    return synthesize_phonemes_with_alignment(
        phones, duration=duration, f0=f0, sr=sr, seed=seed
    )[0]


def synthesize_ipa(
    text: str,
    duration: float = 0.12,
    f0: float = 120.0,
    sr: int = SAMPLE_RATE,
    seed: int = 0,
) -> np.ndarray:
    """IPA string -> waveform via the metric tokenizer's segmentation."""
    return synthesize_phonemes(
        tokenize_ipa(text), duration=duration, f0=f0, sr=sr, seed=seed
    )


def pronunciation_variants(
    text: str, substitutions: Dict[str, str], **kwargs
) -> Tuple[np.ndarray, np.ndarray, List[str], List[str]]:
    """Original + substituted realizations of the same utterance.

    E.g. substitutions={"ɾ": "t"} fabricates the flap-vs-stop contrast the
    reference tested with Piper phoneme control.
    """
    phones = tokenize_ipa(text)
    variant = [substitutions.get(p, p) for p in phones]
    return (
        synthesize_phonemes(phones, **kwargs),
        synthesize_phonemes(variant, **kwargs),
        phones,
        variant,
    )
