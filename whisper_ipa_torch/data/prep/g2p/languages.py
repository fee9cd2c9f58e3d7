"""Per-language grapheme-to-IPA converters (fi, hu, pl, el, mt).

Rule-based broad transcriptions of the standard orthographies, built on the
longest-match engine. Coverage matches the reference pipeline's converter
set (reference create_dataset_scripts/preprocess_local.py:30-107): Finnish
follows the improved converter's conventions (gemination -> ː, v -> ʋ,
ä/ö -> æ/ø); Hungarian and Polish replace the reference's Epitran
dependency with explicit rules; Greek and Maltese replace the external
multipa converters.
"""

from __future__ import annotations

from .engine import RuleG2P, geminate

# -- Finnish --------------------------------------------------------------
# (reference converters_improved/finnish_to_ipa.py conventions)
_FI_SINGLE = [
    ("a", "ɑ"), ("b", "b"), ("d", "d"), ("e", "e"), ("f", "f"),
    ("g", "ɡ"), ("h", "h"), ("i", "i"), ("j", "j"), ("k", "k"),
    ("l", "l"), ("m", "m"), ("n", "n"), ("o", "o"), ("p", "p"),
    ("r", "r"), ("s", "s"), ("t", "t"), ("u", "u"), ("v", "ʋ"),
    ("w", "w"), ("y", "y"), ("z", "z"), ("ä", "æ"), ("ö", "ø"),
]
finnish = RuleG2P(
    geminate(_FI_SINGLE)
    + [
        ("aa", "ɑː"), ("ee", "eː"), ("ii", "iː"), ("oo", "oː"),
        ("uu", "uː"), ("yy", "yː"), ("ää", "æː"), ("öö", "øː"),
        ("ng", "ŋː"), ("nk", "ŋk"),
    ]
)

# -- Hungarian ------------------------------------------------------------
_HU_SINGLE = [
    ("a", "ɒ"), ("b", "b"), ("c", "t͡s"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "ɡ"), ("h", "h"), ("i", "i"), ("j", "j"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "o"),
    ("p", "p"), ("r", "r"), ("s", "ʃ"), ("t", "t"), ("u", "u"),
    ("v", "v"), ("z", "z"),
]
hungarian = RuleG2P(
    geminate(_HU_SINGLE)
    + [
        ("á", "aː"), ("é", "eː"), ("í", "iː"), ("ó", "oː"),
        ("ö", "ø"), ("ő", "øː"), ("ú", "uː"), ("ü", "y"), ("ű", "yː"),
        ("cs", "t͡ʃ"), ("dz", "d͡z"), ("dzs", "d͡ʒ"), ("gy", "ɟ"),
        ("ly", "j"), ("ny", "ɲ"), ("sz", "s"), ("ty", "c"), ("zs", "ʒ"),
        # geminated digraphs (written as e.g. ssz, tty, nny)
        ("ssz", "sː"), ("zzs", "ʒː"), ("ccs", "t͡ʃː"), ("tty", "cː"),
        ("ggy", "ɟː"), ("nny", "ɲː"), ("lly", "jː"),
    ]
)

# -- Polish ---------------------------------------------------------------
polish = RuleG2P(
    [
        ("a", "a"), ("ą", "ɔ̃"), ("b", "b"), ("c", "t͡s"), ("ć", "tɕ"),
        ("d", "d"), ("e", "ɛ"), ("ę", "ɛ̃"), ("f", "f"), ("g", "ɡ"),
        ("h", "x"), ("i", "i"), ("j", "j"), ("k", "k"), ("l", "l"),
        ("ł", "w"), ("m", "m"), ("n", "n"), ("ń", "ɲ"), ("o", "ɔ"),
        ("ó", "u"), ("p", "p"), ("r", "r"), ("s", "s"), ("ś", "ɕ"),
        ("t", "t"), ("u", "u"), ("w", "v"), ("y", "ɨ"), ("z", "z"),
        ("ź", "ʑ"), ("ż", "ʐ"),
        ("ch", "x"), ("cz", "t͡ʂ"), ("dz", "d͡z"), ("dź", "d͡ʑ"),
        ("dż", "d͡ʐ"), ("rz", "ʐ"), ("sz", "ʂ"),
        # c -> t͡s (tie-bar convention, matching Epitran's pol-Latn)
        ("c", "t͡s"), ("ć", "t͡ɕ"),
        # palatal consonant + i + vowel: i is only a palatalization mark
        ("dzia", "d͡ʑa"), ("dzie", "d͡ʑɛ"), ("dzio", "d͡ʑɔ"),
        ("dziu", "d͡ʑu"), ("dzią", "d͡ʑɔ̃"), ("dzię", "d͡ʑɛ̃"),
        ("dzió", "d͡ʑu"), ("dzi", "d͡ʑi"),
        ("kie", "kʲɛ"), ("kia", "kʲa"), ("kio", "kʲɔ"), ("kiu", "kʲu"),
        ("gie", "ɡʲɛ"), ("gia", "ɡʲa"), ("gio", "ɡʲɔ"), ("giu", "ɡʲu"),
        ("cia", "t͡ɕa"), ("cie", "t͡ɕɛ"), ("cio", "t͡ɕɔ"), ("ciu", "t͡ɕu"),
        ("cią", "t͡ɕɔ̃"), ("cię", "t͡ɕɛ̃"), ("ció", "t͡ɕu"),
        ("sia", "ɕa"), ("sie", "ɕɛ"), ("sio", "ɕɔ"), ("siu", "ɕu"),
        ("sią", "ɕɔ̃"), ("się", "ɕɛ̃"), ("sió", "ɕu"),
        ("zia", "ʑa"), ("zie", "ʑɛ"), ("zio", "ʑɔ"), ("ziu", "ʑu"),
        ("zią", "ʑɔ̃"), ("zię", "ʑɛ̃"), ("zió", "ʑu"),
        ("nia", "ɲa"), ("nie", "ɲɛ"), ("nio", "ɲɔ"), ("niu", "ɲu"),
        ("nią", "ɲɔ̃"), ("nię", "ɲɛ̃"), ("nió", "ɲu"),
        ("ci", "t͡ɕi"), ("si", "ɕi"), ("zi", "ʑi"), ("ni", "ɲi"),
        # i before a vowel glides
        ("ia", "ja"), ("ie", "jɛ"), ("io", "jɔ"), ("iu", "ju"),
        ("ią", "jɔ̃"), ("ię", "jɛ̃"), ("ió", "ju"),
    ],
    post=[
        # rz devoices after a voiceless obstruent (przy -> pʂɨ)
        (r"(?<=[ptkxsfɕʂ])ʐ", "ʂ"),
        # word-final affricate devoicing (before the single-char rules)
        (r"d͡ʑ(?=\s|$)", "t͡ɕ"),
        (r"d͡ʐ(?=\s|$)", "t͡ʂ"),
        (r"d͡z(?=\s|$)", "t͡s"),
        # word-final obstruent devoicing
        (r"b(?=\s|$)", "p"),
        (r"d(?=\s|$)", "t"),
        (r"ɡ(?=\s|$)", "k"),
        (r"v(?=\s|$)", "f"),
        (r"z(?=\s|$)", "s"),
        (r"ʐ(?=\s|$)", "ʂ"),
        (r"ʑ(?=\s|$)", "ɕ"),
        # v devoices after voiceless obstruents (twój -> tfuj)
        (r"(?<=[ptkxsfɕʂ])v", "f"),
    ],
)

# -- Greek (modern) -------------------------------------------------------
greek = RuleG2P(
    [
        ("α", "a"), ("β", "v"), ("γ", "ɣ"), ("δ", "ð"), ("ε", "e"),
        ("ζ", "z"), ("η", "i"), ("θ", "θ"), ("ι", "i"), ("κ", "k"),
        ("λ", "l"), ("μ", "m"), ("ν", "n"), ("ξ", "ks"), ("ο", "o"),
        ("π", "p"), ("ρ", "ɾ"), ("σ", "s"), ("ς", "s"), ("τ", "t"),
        ("υ", "i"), ("φ", "f"), ("χ", "x"), ("ψ", "ps"), ("ω", "o"),
        # digraph vowels (plain and accented second letters)
        ("αι", "e"), ("ει", "i"), ("οι", "i"), ("ου", "u"), ("υι", "i"),
        ("αί", "e"), ("εί", "i"), ("οί", "i"), ("ού", "u"), ("υί", "i"),
        # αυ/ευ: placeholder resolved to v/f by voicing context in post
        ("αυ", "aU"), ("ευ", "eU"), ("αύ", "aU"), ("εύ", "eU"),
        # nasal+stop digraphs
        ("μπ", "b"), ("ντ", "d"), ("γκ", "ɡ"), ("γγ", "ŋɡ"),
        ("τσ", "ts"), ("τζ", "dz"),
        # modern Greek degeminates double consonants
        ("σσ", "s"), ("λλ", "l"), ("μμ", "m"), ("νν", "n"), ("ππ", "p"),
        ("ττ", "t"), ("κκ", "k"), ("ρρ", "r"), ("ββ", "v"),
        # accented vowels
        ("ά", "a"), ("έ", "e"), ("ή", "i"), ("ί", "i"), ("ό", "o"),
        ("ύ", "i"), ("ώ", "o"), ("ϊ", "i"), ("ϋ", "i"), ("ΐ", "i"),
        ("ΰ", "i"),
    ],
    post=[
        # αυ/ευ placeholder: v before voiced, f otherwise
        (r"U(?=[bdɡvðzmnlɾrɣʝaeiou])", "v"),
        (r"U", "f"),
        # velar fricatives palatalize before front vowels (corpus keeps
        # stops k/x unpalatalized but fricatives γ/χ become ʝ/ç)
        (r"ɣ(?=[ie])", "ʝ"),
        (r"x(?=[ie])", "ç"),
        # λι/νι + vowel -> palatals
        (r"li(?=[aeou])", "ʎ"),
        (r"ni(?=[aeou])", "ɲ"),
        # ʝi + vowel: the i is absorbed (γιο -> ʝo)
        (r"ʝi(?=[aeou])", "ʝ"),
    ],
)

# -- Maltese --------------------------------------------------------------
_MT_SINGLE = [
    ("a", "a"), ("b", "b"), ("d", "d"), ("e", "ɛ"), ("f", "f"),
    ("g", "ɡ"), ("h", ""), ("i", "i"), ("j", "j"), ("k", "k"),
    ("l", "l"), ("m", "m"), ("n", "n"), ("o", "o"), ("p", "p"),
    ("q", "ʔ"), ("r", "ɾ"), ("s", "s"), ("t", "t"), ("u", "u"),
    ("v", "v"), ("w", "w"), ("x", "ʃ"), ("z", "t͡s"),
]
maltese = RuleG2P(
    geminate(_MT_SINGLE)
    + [
        ("ċ", "t͡ʃ"), ("ġ", "d͡ʒ"), ("ħ", "ħ"), ("ż", "z"),
        ("rr", "ɾː"),
        ("għ", ""),  # silent, typically lengthens the adjacent vowel
        ("ie", "iː"),
    ]
)

CONVERTERS = {
    "fi": finnish,
    "hu": hungarian,
    "pl": polish,
    "el": greek,
    "mt": maltese,
}
