"""Articulatory feature system for IPA segments (24-dim vectors).

A self-contained re-implementation of the feature-vector contract used by the
reference metrics (panphon-style 24 binary features per phone; reference
scripts/evaluate_ipa.py:108-163). panphon is not vendored; instead the table
is *generated* from articulatory descriptions (place/manner/voicing for
consonants, height/backness/rounding/tenseness for vowels) plus diacritic
modification rules. Unknown phones map to the zero vector, matching the
reference's fallback behavior.

Feature order (panphon convention):
    syl son cons cont delrel lat nas strid voi sg cg
    ant cor distr lab hi lo back round velaric tense long hitone hireg

Values are in {-1, 0, +1}.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Dict, Optional

import numpy as np

FEATURE_NAMES = (
    "syl", "son", "cons", "cont", "delrel", "lat", "nas", "strid", "voi",
    "sg", "cg", "ant", "cor", "distr", "lab", "hi", "lo", "back", "round",
    "velaric", "tense", "long", "hitone", "hireg",
)
NUM_FEATURES = len(FEATURE_NAMES)  # 24
_IDX = {name: i for i, name in enumerate(FEATURE_NAMES)}

# -- consonant description space -----------------------------------------

# place classes. Palatals are coronal-dorsal complexes in the Hayes/panphon
# system (+cor, -ant, +distr, +hi) — see docs/PARITY.md "feature table".
_CORONAL_PLACES = {
    "dental", "alveolar", "postalveolar", "retroflex", "alveolopalatal",
    "palatal",
}
_LABIAL_PLACES = {"bilabial", "labiodental", "labiovelar"}
_DORSAL_HI = {"palatal", "velar", "labiovelar", "alveolopalatal"}
_DORSAL_BACK = {"velar", "uvular", "pharyngeal", "labiovelar"}

_SONORANT_MANNERS = {"nasal", "trill", "tap", "approximant", "lateral_approximant"}
_CONTINUANT_MANNERS = {
    "fricative", "lateral_fricative", "approximant", "lateral_approximant", "trill",
}
_SIBILANTS = set("szʃʒʂʐɕʑʧʤʦʣʨʥ")


def _consonant_vector(
    sym: str,
    place: str,
    manner: str,
    voiced: bool,
    *,
    glide: bool = False,
    lateral: bool = False,
    rounded: bool = False,
) -> np.ndarray:
    v = np.zeros(NUM_FEATURES, dtype=np.int8)

    def s(name, val):
        v[_IDX[name]] = val

    s("syl", -1)
    s("son", 1 if manner in _SONORANT_MANNERS or glide else -1)
    s("cons", -1 if (place == "glottal" or glide) else 1)
    s("cont", 1 if manner in _CONTINUANT_MANNERS or glide else -1)
    s("delrel", 1 if manner == "affricate" else -1)
    s("lat", 1 if lateral or "lateral" in manner else -1)
    s("nas", 1 if manner == "nasal" else -1)
    s("strid", 1 if (sym and sym[0] in _SIBILANTS or place == "labiodental"
                     and manner in ("fricative", "affricate")) else -1)
    s("voi", 1 if voiced else -1)
    s("sg", 1 if sym in ("h", "ɦ", "ʍ") and place == "glottal" or sym in ("h", "ɦ") else -1)
    s("cg", 1 if sym == "ʔ" or manner == "implosive" else -1)

    # [anterior]/[distributed] are coronal-dependent in the Hayes/panphon
    # system: non-coronals (labials included) get 0, not ±
    if place in _CORONAL_PLACES:
        s("cor", 1)
        s("ant", 1 if place in ("dental", "alveolar") else -1)
        s("distr", 1 if place in (
            "dental", "postalveolar", "alveolopalatal", "palatal"
        ) else -1)
    else:
        s("cor", -1)
        s("ant", 0)
        s("distr", 0)

    s("lab", 1 if place in _LABIAL_PLACES or rounded else -1)
    s("hi", 1 if place in _DORSAL_HI else -1)
    s("lo", 1 if place == "pharyngeal" else -1)
    s("back", 1 if place in _DORSAL_BACK else -1)
    s("round", 1 if rounded else -1)
    s("velaric", 1 if manner == "click" else -1)
    s("tense", 0)
    s("long", -1)
    return v


def _vowel_vector(
    height: str,  # hi, nearhi, himid, mid, lomid, nearlo, lo
    backness: str,  # front, central, back
    rounded: bool,
    tense: bool,
    *,
    rhotic: bool = False,
) -> np.ndarray:
    v = np.zeros(NUM_FEATURES, dtype=np.int8)

    def s(name, val):
        v[_IDX[name]] = val

    s("syl", 1)
    s("son", 1)
    s("cons", -1)
    s("cont", 1)
    s("delrel", -1)
    s("lat", -1)
    s("nas", -1)
    s("strid", -1)  # panphon marks vowels -strid, not 0
    s("voi", 1)
    s("sg", -1)
    s("cg", -1)
    s("ant", 0)
    s("cor", 1 if rhotic else -1)
    s("distr", 0)
    s("lab", 1 if rounded else -1)
    s("hi", 1 if height in ("hi", "nearhi") else -1)
    s("lo", 1 if height in ("lo", "nearlo") else -1)
    s("back", {"front": -1, "central": 0, "back": 1}[backness])
    s("round", 1 if rounded else -1)
    s("velaric", -1)
    s("tense", 1 if tense else -1)
    s("long", -1)
    return v


# -- base segment inventory ----------------------------------------------

def _build_base_table() -> Dict[str, np.ndarray]:
    C = _consonant_vector
    V = _vowel_vector
    t: Dict[str, np.ndarray] = {}

    # stops
    for sym, place, vd in [
        ("p", "bilabial", False), ("b", "bilabial", True),
        ("t", "alveolar", False), ("d", "alveolar", True),
        ("ʈ", "retroflex", False), ("ɖ", "retroflex", True),
        ("c", "palatal", False), ("ɟ", "palatal", True),
        ("k", "velar", False), ("ɡ", "velar", True), ("g", "velar", True),
        ("q", "uvular", False), ("ɢ", "uvular", True),
        ("ʔ", "glottal", False),
    ]:
        t[sym] = C(sym, place, "stop", vd)

    # nasals
    for sym, place in [
        ("m", "bilabial"), ("ɱ", "labiodental"), ("n", "alveolar"),
        ("ɳ", "retroflex"), ("ɲ", "palatal"), ("ŋ", "velar"), ("ɴ", "uvular"),
    ]:
        t[sym] = C(sym, place, "nasal", True)

    # trills / taps
    t["ʙ"] = C("ʙ", "bilabial", "trill", True)
    t["r"] = C("r", "alveolar", "trill", True)
    t["ʀ"] = C("ʀ", "uvular", "trill", True)
    t["ɾ"] = C("ɾ", "alveolar", "tap", True)
    t["ɽ"] = C("ɽ", "retroflex", "tap", True)
    t["ⱱ"] = C("ⱱ", "labiodental", "tap", True)

    # fricatives
    for sym, place, vd in [
        ("ɸ", "bilabial", False), ("β", "bilabial", True),
        ("f", "labiodental", False), ("v", "labiodental", True),
        ("θ", "dental", False), ("ð", "dental", True),
        ("s", "alveolar", False), ("z", "alveolar", True),
        ("ʃ", "postalveolar", False), ("ʒ", "postalveolar", True),
        ("ʂ", "retroflex", False), ("ʐ", "retroflex", True),
        ("ɕ", "alveolopalatal", False), ("ʑ", "alveolopalatal", True),
        ("ç", "palatal", False), ("ʝ", "palatal", True),
        ("x", "velar", False), ("ɣ", "velar", True),
        ("χ", "uvular", False), ("ʁ", "uvular", True),
        ("ħ", "pharyngeal", False), ("ʕ", "pharyngeal", True),
        ("h", "glottal", False), ("ɦ", "glottal", True),
    ]:
        t[sym] = C(sym, place, "fricative", vd)
    t["ɬ"] = C("ɬ", "alveolar", "lateral_fricative", False)
    t["ɮ"] = C("ɮ", "alveolar", "lateral_fricative", True)
    t["ʍ"] = C("ʍ", "labiovelar", "fricative", False, glide=True)

    # single-codepoint affricates
    for sym, place, vd in [
        ("ʦ", "alveolar", False), ("ʣ", "alveolar", True),
        ("ʧ", "postalveolar", False), ("ʤ", "postalveolar", True),
        ("ʨ", "alveolopalatal", False), ("ʥ", "alveolopalatal", True),
    ]:
        t[sym] = C(sym, place, "affricate", vd)

    # approximants
    t["ʋ"] = C("ʋ", "labiodental", "approximant", True)
    t["ɹ"] = C("ɹ", "alveolar", "approximant", True)
    t["ɻ"] = C("ɻ", "retroflex", "approximant", True)
    t["j"] = C("j", "palatal", "approximant", True, glide=True)
    t["ɰ"] = C("ɰ", "velar", "approximant", True, glide=True)
    t["w"] = C("w", "labiovelar", "approximant", True, glide=True, rounded=True)
    t["ɥ"] = C("ɥ", "labiovelar", "approximant", True, glide=True, rounded=True)
    # laterals
    t["l"] = C("l", "alveolar", "lateral_approximant", True)
    t["ɭ"] = C("ɭ", "retroflex", "lateral_approximant", True)
    t["ʎ"] = C("ʎ", "palatal", "lateral_approximant", True)
    t["ʟ"] = C("ʟ", "velar", "lateral_approximant", True)
    t["ɫ"] = t["l"].copy()  # velarized l
    t["ɫ"][_IDX["hi"]] = 1
    t["ɫ"][_IDX["back"]] = 1

    # implosives
    for sym, place in [
        ("ɓ", "bilabial"), ("ɗ", "alveolar"), ("ʄ", "palatal"),
        ("ɠ", "velar"), ("ʛ", "uvular"),
    ]:
        t[sym] = C(sym, place, "implosive", True)

    # vowels: (symbol, height, backness, rounded, tense)
    for sym, h, b, rd, tn in [
        ("i", "hi", "front", False, True),
        ("y", "hi", "front", True, True),
        ("ɨ", "hi", "central", False, False),
        ("ʉ", "hi", "central", True, False),
        ("ɯ", "hi", "back", False, True),
        ("u", "hi", "back", True, True),
        ("ɪ", "nearhi", "front", False, False),
        ("ʏ", "nearhi", "front", True, False),
        ("ʊ", "nearhi", "back", True, False),
        ("e", "himid", "front", False, True),
        ("ø", "himid", "front", True, True),
        ("ɘ", "himid", "central", False, False),
        ("ɵ", "himid", "central", True, False),
        ("ɤ", "himid", "back", False, True),
        ("o", "himid", "back", True, True),
        ("ə", "mid", "central", False, False),
        ("ɛ", "lomid", "front", False, False),
        ("œ", "lomid", "front", True, False),
        ("ɜ", "lomid", "central", False, False),
        ("ɞ", "lomid", "central", True, False),
        ("ʌ", "lomid", "back", False, False),
        ("ɔ", "lomid", "back", True, False),
        ("æ", "nearlo", "front", False, False),
        ("ɐ", "nearlo", "central", False, False),
        ("a", "lo", "front", False, True),
        ("ɶ", "lo", "front", True, False),
        ("ɑ", "lo", "back", False, True),
        ("ɒ", "lo", "back", True, False),
    ]:
        t[sym] = V(h, b, rd, tn)
    t["ɚ"] = V("mid", "central", False, False, rhotic=True)
    t["ɝ"] = V("lomid", "central", False, False, rhotic=True)
    return t


_BASE_TABLE = _build_base_table()

# Optional exact-compat mode: when a real panphon segment CSV is available
# (ipa_all.csv layout: first column the segment, then 24 feature columns
# with +/-/0), load it as an overriding lookup so PFER values are
# bit-identical to panphon-based pipelines. Set WHISPER_IPA_TPU_PANPHON_CSV.
_EXACT_TABLE: Dict[str, np.ndarray] = {}


def load_panphon_csv(path: str) -> int:
    """Load a panphon-format feature CSV as the exact lookup table.

    Returns the number of segments loaded. Values map + -> 1, - -> -1,
    0 -> 0. Later duplicate segments are ignored (panphon keeps the first).
    """
    import csv

    count = 0
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        n_feat = min(NUM_FEATURES, len(header) - 1)
        for row in reader:
            if not row or not row[0]:
                continue
            seg = unicodedata.normalize("NFC", row[0])
            if seg in _EXACT_TABLE:
                continue
            vec = np.zeros(NUM_FEATURES, dtype=np.int8)
            for i in range(n_feat):
                val = row[1 + i].strip()
                vec[i] = 1 if val == "+" else (-1 if val == "-" else 0)
            _EXACT_TABLE[seg] = vec
            count += 1
    phone_to_vector.cache_clear()
    return count


import os as _os

_csv_path = _os.environ.get("WHISPER_IPA_TPU_PANPHON_CSV")
if _csv_path and _os.path.isfile(_csv_path):
    load_panphon_csv(_csv_path)

# -- diacritic modification rules ----------------------------------------
# mark -> {feature: value} applied on top of the base segment's vector
_DIACRITICS: Dict[str, Dict[str, int]] = {
    "̥": {"voi": -1},             # ring below (voiceless)
    "̊": {"voi": -1},             # ring above
    "̬": {"voi": 1},              # caron below (voiced)
    "ʰ": {"sg": 1},               # aspirated
    "ʱ": {"sg": 1, "voi": 1},     # breathy aspirated
    "̩": {"syl": 1},              # syllabic
    "̍": {"syl": 1},              # syllabic (above)
    "̃": {"nas": 1},              # nasalized
    "ː": {"long": 1},             # long
    "ˑ": {"long": 1},             # half-long
    "ʲ": {"hi": 1, "back": -1},   # palatalized
    "ʷ": {"round": 1, "lab": 1},  # labialized
    "ˠ": {"hi": 1, "back": 1},    # velarized
    "ˤ": {"lo": 1, "back": 1},    # pharyngealized
    "̴": {"hi": 1, "back": 1},    # velarized/pharyngealized tilde overlay
    "̤": {"sg": 1},               # breathy voiced
    "̰": {"cg": 1},               # creaky voiced
    "̪": {"ant": 1, "distr": 1},  # dental
    "̺": {"distr": -1},           # apical
    "̞": {"tense": -1},           # lowered (true-mid e̞ o̞ are lax)
    "̈": {"back": 0},             # centralized (ä: front -> central)
    "ʼ": {"cg": 1},               # ejective
    "́": {"hitone": 1, "hireg": 1},    # high tone
    "̀": {"hitone": -1, "hireg": -1},  # low tone
    "˥": {"hitone": 1, "hireg": 1},    # tone letter: extra high
    "˦": {"hitone": 1, "hireg": 1},    # tone letter: high
    "˧": {},                            # tone letter: mid
    "˨": {"hitone": -1, "hireg": -1},  # tone letter: low
    "˩": {"hitone": -1, "hireg": -1},  # tone letter: extra low
}

_TIE_BARS = ("͡", "͜")

# Non-IPA characters that leak through real-corpus G2P with a known
# phonetic identity (inventory from the reference data snapshot,
# tests/test_reference_data.py). Greek iota/upsilon survive in words the
# Greek G2P passed through (both are /i/ in Modern Greek); the Tamil
# aytam ஃ is /x/ (and marks /f/ in loanword ஃப); fullwidth Latin
# (ｌ, ａ, ...) NFKC-folds to the ASCII letter, handled generically below.
_CHAR_FOLD = {"ι": "i", "υ": "i", "ஃ": "x"}


def _fold_char(ch: str) -> Optional[str]:
    """Map a non-IPA character to its IPA-table equivalent, if any."""
    if ch in _CHAR_FOLD:
        return _CHAR_FOLD[ch]
    folded = unicodedata.normalize("NFKC", ch)
    if folded != ch and folded[:1] in _BASE_TABLE:
        return folded[:1]
    return None


def _is_boundary(phone: str) -> bool:
    """Juncture/punctuation 'phones' (e.g. the Japanese moraic-nasal
    separator ' in ze̞n'in, the katakana middle dot ・): real corpora
    contain them and the reference segments them as standalone phones
    (its panphon-drop fallback, scripts/evaluate_ipa.py:53-65), scoring
    them with the all-zero except-path vector. We keep the identical
    zero cost but classify them as KNOWN boundary symbols."""
    return all(
        unicodedata.category(ch).startswith(("P", "Z")) for ch in phone
    )


@lru_cache(maxsize=4096)
def phone_to_vector(phone: str) -> Optional[np.ndarray]:
    """Feature vector for a single phone (base char + marks), or None.

    Tie-bar digraphs (t͡ʃ) resolve to the single-codepoint affricate when one
    exists, else to the first base's vector with delayed release.
    """
    if not phone:
        return None
    phone = unicodedata.normalize("NFC", phone)

    exact = _EXACT_TABLE.get(phone)
    if exact is not None:
        return exact.copy()

    if _is_boundary(phone):
        return np.zeros(NUM_FEATURES, dtype=np.int8)

    # tie-bar affricates / doubly articulated
    for tie in _TIE_BARS:
        if tie in phone:
            parts = phone.split(tie)
            joined = "".join(parts)
            single = {
                "ts": "ʦ", "dz": "ʣ", "tʃ": "ʧ", "dʒ": "ʤ",
                "tɕ": "ʨ", "dʑ": "ʥ",
            }.get(joined)
            if single is not None:
                return _BASE_TABLE[single].copy()
            # other affricates (t͡ʂ, d͡ʐ, ...): the fricative part carries
            # place/stridency/voicing; the stop part contributes -cont,
            # +delrel (panphon's affricate composition)
            if len(parts) == 2 and parts[1][:1] in _BASE_TABLE:
                v = _BASE_TABLE[parts[1][:1]].copy()
                v[_IDX["cont"]] = -1
                v[_IDX["delrel"]] = 1
                for m in phone[phone.index(tie) + 1 :]:
                    if m in _DIACRITICS:
                        for feat, val in _DIACRITICS[m].items():
                            v[_IDX[feat]] = val
                return v
            base = _BASE_TABLE.get(parts[0][:1])
            if base is not None:
                v = base.copy()
                v[_IDX["delrel"]] = 1
                return v
            return None

    base = None
    marks = []
    for ch in phone:
        if base is None and ch in _BASE_TABLE:
            base = _BASE_TABLE[ch].copy()
        elif ch in _DIACRITICS:
            marks.append(ch)
        elif base is None:
            # try NFD: base letter + combining marks
            decomp = unicodedata.normalize("NFD", ch)
            head = decomp[0]
            if head not in _BASE_TABLE:
                folded = _fold_char(head)
                if folded is not None:
                    head = folded
            if head in _BASE_TABLE:
                base = _BASE_TABLE[head].copy()
                for m in decomp[1:]:
                    if m in _DIACRITICS:
                        marks.append(m)
        # unknown marks are ignored
    if base is None:
        return None
    for m in marks:
        for feat, val in _DIACRITICS[m].items():
            base[_IDX[feat]] = val
    return base


def get_phone_features(phone: str) -> np.ndarray:
    """Vector for a phone; zeros for unknown phones (reference fallback)."""
    v = phone_to_vector(phone)
    if v is None:
        return np.zeros(NUM_FEATURES, dtype=np.int8)
    return v


def known_phone(phone: str) -> bool:
    return phone_to_vector(phone) is not None
