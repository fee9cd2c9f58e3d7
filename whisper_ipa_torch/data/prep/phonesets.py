"""Corpus phone-label -> IPA tables.

Standard mappings from published corpus documentation (TIMIT PHONCODE.DOC,
OGI Spelled Speech labels, METUbet for METU Turkish). Behavioral contract
matches the reference converters (reference
scripts/data_prep/prepare_timit_dataset.py:14-93,
prepare_ogi_spelled.py:15-117, prepare_metu_turkish.py:14-69): closures and
silence labels map to the empty string (dropped), allophonic detail (flap,
glottal stop, syllabics, devoiced schwa) is preserved.
"""

from __future__ import annotations

from typing import Dict

# TIMIT 61-label ARPABET set
_TIMIT_STOPS = {
    "b": "b", "d": "d", "g": "ɡ", "p": "p", "t": "t", "k": "k",
    "dx": "ɾ", "q": "ʔ",
}
_TIMIT_CLOSURES = {c: "" for c in ("bcl", "dcl", "gcl", "pcl", "tcl", "kcl")}
_TIMIT_AFFRICATES = {"jh": "dʒ", "ch": "tʃ"}
_TIMIT_FRICATIVES = {
    "s": "s", "sh": "ʃ", "z": "z", "zh": "ʒ",
    "f": "f", "th": "θ", "v": "v", "dh": "ð",
}
_TIMIT_NASALS = {
    "m": "m", "n": "n", "ng": "ŋ",
    "em": "m̩", "en": "n̩", "eng": "ŋ̍", "nx": "ɾ̃",
}
_TIMIT_GLIDES = {
    "l": "l", "r": "ɹ", "w": "w", "y": "j",
    "hh": "h", "hv": "ɦ", "el": "l̩",
}
_TIMIT_MONOPHTHONGS = {
    "iy": "i", "ih": "ɪ", "eh": "ɛ", "ae": "æ", "aa": "ɑ",
    "ah": "ʌ", "ao": "ɔ", "uh": "ʊ", "uw": "u", "ux": "ʉ",
    "er": "ɝ", "ax": "ə", "ix": "ɨ", "axr": "ɚ", "ax-h": "ə̥",
}
_TIMIT_DIPHTHONGS = {
    "ey": "eɪ", "ay": "aɪ", "oy": "ɔɪ", "aw": "aʊ", "ow": "oʊ",
}
_TIMIT_SILENCE = {"pau": "", "epi": "", "h#": ""}

TIMIT_ARPABET_TO_IPA: Dict[str, str] = {
    **_TIMIT_STOPS,
    **_TIMIT_CLOSURES,
    **_TIMIT_AFFRICATES,
    **_TIMIT_FRICATIVES,
    **_TIMIT_NASALS,
    **_TIMIT_GLIDES,
    **_TIMIT_MONOPHTHONGS,
    **_TIMIT_DIPHTHONGS,
    **_TIMIT_SILENCE,
}

# Labels that never count toward phoneme_count (silence-class)
TIMIT_NONSPEECH = ("pau", "epi", "h#")

# OGI Spelled Speech: TIMIT set + noise markers + r-colored vowels
OGI_ARPABET_TO_IPA: Dict[str, str] = {
    **TIMIT_ARPABET_TO_IPA,
    "cl": "",  # generic closure
    "h": "h",
    # r-colored vowels / incomplete diphthongs
    "ao-r": "ɔɹ", "aa-r": "ɑɹ", "ae-r": "æɹ",
    "ay-": "aɪ", "ax-": "ə",
    # noise/annotation markers (dropped)
    "#h": "", "br": "", "ls": "", "ln": "", "ns": "", "pv": "",
    "gx": "", "bn": "", "xs": "", "unk": "", "-": "",
    "glot": "ʔ",  # glottal stop is phonetic: keep
}
OGI_NONSPEECH = ("#h", "h#", "pau", "epi")

# METUbet (METU Turkish corpus)
METUBET_TO_IPA: Dict[str, str] = {
    # vowels (8 qualities + length)
    "A": "a", "AA": "aː", "E": "e", "EE": "eː",
    "I": "ɯ", "IY": "ɯː", "O": "o", "OE": "ø", "U": "u", "UE": "y",
    # stops (palatal allophones of k/g before front vowels)
    "B": "b", "P": "p", "D": "d", "T": "t",
    "G": "ɡ", "GG": "ɟ", "K": "k", "KK": "c",
    # affricates
    "C": "tʃ", "J": "dʒ", "CH": "tʃ",
    # fricatives
    "F": "f", "V": "v", "VV": "v", "S": "s", "Z": "z",
    "SH": "ʃ", "ZH": "ʒ", "H": "h", "RH": "ɣ",
    # nasals
    "M": "m", "N": "n", "NN": "ŋ",
    # liquids
    "L": "l", "LL": "ɫ", "R": "ɾ", "RR": "r",
    # glides
    "Y": "j",
    # silence
    "SIL": "",
}
METU_NONSPEECH = ("SIL",)
