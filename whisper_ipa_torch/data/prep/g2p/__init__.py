"""Grapheme-to-IPA dispatch for the CommonVoice preprocessing pipeline.

``text_to_ipa(sentence, lang, mode)`` mirrors the reference surface
(reference create_dataset_scripts/preprocess_local.py:77-107) over
first-party converters: ja (kana), mt, fi, el, ta (script + sandhi),
hu, pl. Spaces are stripped from the result (the training convention).
"""

from __future__ import annotations

from .engine import RuleG2P, geminate
from .japanese import Japanese2IPA, kana_to_ipa, remove_ja_punct
from .languages import CONVERTERS, finnish, greek, hungarian, maltese, polish
from .tamil import Tamil2IPA, apply_sandhi, transliterate

SUPPORTED_LANGUAGES = ("ja", "pl", "mt", "hu", "fi", "el", "ta")


def text_to_ipa(sentence: str, lang: str, mode: str = "raw") -> str:
    """Orthographic text -> IPA (spaces removed). Raises on unsupported."""
    del mode  # all converters here are the improved first-party ones
    if lang == "ja":
        ipa = kana_to_ipa(remove_ja_punct(sentence))
    elif lang == "ta":
        ipa = apply_sandhi(transliterate(sentence))
    elif lang in CONVERTERS:
        ipa = CONVERTERS[lang](sentence)
    else:
        raise ValueError(f"Unknown language: {lang}")
    # note: identical consonants meeting across word boundaries stay as two
    # phones (the reference converters geminate only within words, before
    # the space strip) — verified bit-exact vs the v3_improved corpus
    return "".join(ipa.split())


__all__ = [
    "CONVERTERS",
    "Japanese2IPA",
    "RuleG2P",
    "SUPPORTED_LANGUAGES",
    "Tamil2IPA",
    "geminate",
    "text_to_ipa",
]
