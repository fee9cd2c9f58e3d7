"""IPA string → phone segmentation.

Contract (reference scripts/evaluate_ipa.py:27-77 and its assertion suite):
  - spaces are removed before segmentation
  - combining marks (Unicode category M*) attach to the preceding base char
  - spacing modifier letters in U+02B0..U+02FF (category Lm: aspiration,
    length mark, palatalization, ...) attach to the preceding base char
  - tie bars (U+0361, U+035C) additionally join the *following* base char,
    so t͡ʃ is one segment while plain tʃ splits into two
  - normalization replaces Latin g (U+0067) with IPA ɡ (U+0261) and applies
    NFC (Taguchi's convention)
"""

from __future__ import annotations

import unicodedata
from typing import List

_TIE_BARS = ("͡", "͜")


def _attaches_to_previous(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return cat.startswith("M") or (cat == "Lm" and "ʰ" <= ch <= "˿")


def tokenize_ipa(text: str) -> List[str]:
    """Segment an IPA string into phones."""
    text = text.replace(" ", "")
    if not text:
        return []

    segments: List[str] = []
    tie_pending = False
    for ch in text:
        if segments and (_attaches_to_previous(ch) or tie_pending):
            segments[-1] += ch
            tie_pending = ch in _TIE_BARS
        else:
            segments.append(ch)
            tie_pending = ch in _TIE_BARS
    return segments


def normalize_ipa_for_comparison(text: str) -> str:
    """NFC-normalize, strip spaces, and map Latin g to IPA ɡ."""
    text = unicodedata.normalize("NFC", text)
    text = text.replace(" ", "")
    text = text.replace("g", "ɡ")
    return text
