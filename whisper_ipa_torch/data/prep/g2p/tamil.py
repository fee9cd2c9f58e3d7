"""Tamil script -> IPA with contextual voicing post-rules.

Two stages, mirroring the reference's improved Tamil pipeline
(reference create_dataset_scripts/converters_improved/tamil_to_ipa.py):

  1. transliterate the Tamil abugida (inherent-a consonants, vowel signs,
     virama) to a broad IPA — replacing the reference's Epitran dependency
  2. apply Tamil sandhi/allophony: plain stops voice between sonorants,
     nasal+stop clusters voice, geminates -> ː, word-initial e -> je,
     u -> ɯ (with uː retained)
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List

# independent vowels
_INDEP: Dict[str, str] = {
    "அ": "a", "ஆ": "aː", "இ": "i", "ஈ": "iː", "உ": "u", "ஊ": "uː",
    "எ": "e", "ஏ": "eː", "ஐ": "aj", "ஒ": "o", "ஓ": "oː", "ஔ": "aʋ",
}
# consonants (inherent a added unless a vowel sign / virama follows)
_CONS: Dict[str, str] = {
    "க": "k", "ங": "ŋ", "ச": "t͡ʃ", "ஞ": "ɲ", "ட": "ʈ", "ண": "ɳ",
    "த": "t̪", "ந": "n̪", "ப": "p", "ம": "m", "ய": "j", "ர": "ɾ",
    "ல": "l", "வ": "ʋ", "ழ": "ɻ", "ள": "ɭ", "ற": "r", "ன": "n",
    # grantha letters
    "ஜ": "dʒ", "ஷ": "ʂ", "ஸ": "s", "ஹ": "h",
}
# dependent vowel signs
_SIGNS: Dict[str, str] = {
    "ா": "aː", "ி": "i", "ீ": "iː", "ு": "u", "ூ": "uː",
    "ெ": "e", "ே": "eː", "ை": "aj", "ொ": "o", "ோ": "oː", "ௌ": "aʋ",
}
_VIRAMA = "்"


def transliterate(text: str) -> str:
    """Tamil script -> broad IPA (inherent-a abugida semantics)."""
    text = unicodedata.normalize("NFC", text)
    out: List[str] = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if ch in _CONS:
            base = _CONS[ch]
            nxt = text[i + 1] if i + 1 < n else ""
            if nxt == _VIRAMA:
                out.append(base)
                i += 2
            elif nxt in _SIGNS:
                out.append(base + _SIGNS[nxt])
                i += 2
            else:
                out.append(base + "a")
                i += 1
        elif ch in _INDEP:
            out.append(_INDEP[ch])
            i += 1
        elif ch.isspace():
            out.append(" ")
            i += 1
        else:
            i += 1  # drop punctuation/unknown
    return "".join(out)


_VOICEABLE = {"k": "g", "q": "d͡ʑ", "x": "d̪", "p": "b", "ʈ": "ɖ", "t": "d"}
_CLUSTERS = [
    ("ŋk", "ŋg"), ("n̪x", "n̪d̪"), ("ɲq", "ɲd͡ʑ"), ("ɳʈ", "ɳɖ"),
    ("mp", "mb"), ("rr", "tːr"), ("pp", "pː"), ("kk", "kː"),
    ("xx", "t̪ː"), ("ʈʈ", "ʈː"), ("qq", "t͡ɕː"), ("nr", "ndr"),
    ("ɯː", "uː"),
]
_SONORANTS = set("aɯieojɾː")
_VOWELS = set("aɯieo")


def apply_sandhi(sent: str) -> str:
    """Contextual voicing + gemination + initial-e glide (reference rules)."""
    # work in single-char placeholders for the multi-char affricates
    sent = sent.replace("t͡ʃ", "q").replace("t̪", "x").replace("u", "ɯ")
    for k, v in _CLUSTERS:
        sent = sent.replace(k, v)

    chars = list(sent)
    for i, c in enumerate(sent):
        if 1 <= i < len(sent) - 1:
            if (
                sent[i - 1] in _SONORANTS
                and sent[i + 1] in _SONORANTS
                and sent[i + 1] != "ː"  # geminates never voice
                and c in _VOICEABLE
            ):
                chars[i] = _VOICEABLE[c]
        if 2 <= i < len(sent) - 1:
            if (
                sent[i - 2] in _VOWELS
                and sent[i - 1] == "ː"
                and sent[i + 1] in _SONORANTS
                and c in _VOICEABLE
            ):
                chars[i] = _VOICEABLE[c]
    sent = "".join(chars)
    sent = sent.replace("q", "t͡ɕ").replace("x", "t̪")

    tokens = sent.split()
    for i, t in enumerate(tokens):
        if t.startswith("e"):
            tokens[i] = "j" + t
    sent = " ".join(tokens)

    keep = (
        r"[\s\wɐ-ʯʰ-˿ᴀ-ᵿᶀ-ᶿ"
        r"̀-ͯ]"
    )
    return "".join(re.findall(keep, sent, re.MULTILINE))


class Tamil2IPA:
    """Reference-surface converter class."""

    @classmethod
    def tamil_generate_ipa(cls, sent: str) -> str:
        return apply_sandhi(transliterate(sent))
