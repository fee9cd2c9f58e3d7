"""Whisper tokenizer: BPE vocabulary + the special-token control layout.

Special-token id layout (multilingual, 99 languages — vocab 51865):

    0..50256      base BPE vocabulary
    50257         <|endoftext|>
    50258         <|startoftranscript|>
    50259..50357  language tokens (99)
    50358         <|translate|>
    50359         <|transcribe|>
    50360         <|startoflm|>
    50361         <|startofprev|>
    50362         <|nospeech|>
    50363         <|notimestamps|>
    50364..51864  timestamps <|0.00|> .. <|30.00|> (1501, 0.02 s steps)

large-v3 adds a 100th language (yue), shifting everything after the language
block up by one (vocab 51866). Ids are derived from the layout, never
hard-coded, so both variants are supported.

Behavioral reference: the upstream pipeline's training sequence format
``<|startoftranscript|><|en|><|transcribe|><|notimestamps|>[IPA]<|endoftext|>``
(reference scripts/ipa_data_loader.py:102-131,
WHISPER_IPA_RESEARCH_STANDALONE.md:313-350).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

from .bpe import BPE, byte_level_ranks, load_tiktoken_ranks

# The 99 Whisper language codes in canonical id order; large-v3 appends "yue".
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
)
LANGUAGES_V3 = LANGUAGES + ("yue",)

N_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|> in 0.02 s increments

# Environment variable pointing at a real multilingual.tiktoken rank file.
RANKS_ENV_VAR = "WHISPER_IPA_TPU_TIKTOKEN"


def _find_ranks_file(explicit: Optional[str]) -> Optional[str]:
    candidates = [explicit, os.environ.get(RANKS_ENV_VAR)]
    here = os.path.dirname(os.path.abspath(__file__))
    candidates += [
        os.path.join(here, "assets", "multilingual.tiktoken"),
        os.path.join(here, "..", "..", "assets", "multilingual.tiktoken"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


@dataclass
class WhisperTokenizer:
    """BPE + special tokens, mirroring the reference tokenizer surface."""

    bpe: BPE
    n_base: int = 50257
    num_languages: int = 99
    language: Optional[str] = "en"
    task: str = "transcribe"
    # which vocabulary produced these ids: "tiktoken:<sha256[:12]>" for a
    # real rank file, "byte-fallback" otherwise. Stamped into checkpoints so
    # models trained on one vocabulary are never silently evaluated with
    # another (their text-token ids are incompatible).
    provenance: str = "byte-fallback"

    special_tokens: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.special_tokens:
            self.special_tokens = self._build_specials()
        self._id_to_special = {v: k for k, v in self.special_tokens.items()}

    # -- layout -----------------------------------------------------------
    def _build_specials(self) -> Dict[str, int]:
        langs = LANGUAGES_V3 if self.num_languages == 100 else LANGUAGES
        langs = langs[: self.num_languages]
        specials: Dict[str, int] = {}
        nid = self.n_base
        for name in ("<|endoftext|>", "<|startoftranscript|>"):
            specials[name] = nid
            nid += 1
        for code in langs:
            specials[f"<|{code}|>"] = nid
            nid += 1
        for name in (
            "<|translate|>",
            "<|transcribe|>",
            "<|startoflm|>",
            "<|startofprev|>",
            "<|nospeech|>",
            "<|notimestamps|>",
        ):
            specials[name] = nid
            nid += 1
        for i in range(N_TIMESTAMPS):
            specials[f"<|{i * 0.02:.2f}|>"] = nid
            nid += 1
        return specials

    # -- id properties ----------------------------------------------------
    @cached_property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @property
    def n_vocab(self) -> int:
        return max(self.special_tokens.values()) + 1

    def language_token(self, language: Optional[str] = None) -> int:
        language = language or self.language or "en"
        tok = self.special_tokens.get(f"<|{language}|>")
        if tok is None:
            raise KeyError(f"unknown language code: {language!r}")
        return tok

    @property
    def all_language_tokens(self) -> List[int]:
        langs = LANGUAGES_V3 if self.num_languages == 100 else LANGUAGES
        return [
            self.special_tokens[f"<|{c}|>"] for c in langs[: self.num_languages]
        ]

    # -- SOT sequences ----------------------------------------------------
    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.language_token(self.language))
            seq.append(
                self.transcribe if self.task == "transcribe" else self.translate
            )
        return tuple(seq)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(self.sot_sequence) + (self.no_timestamps,)

    # -- encode / decode --------------------------------------------------
    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        """Decode ids; special tokens render as their <|...|> names."""
        out: List[str] = []
        run: List[int] = []
        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                if run:
                    out.append(self.bpe.decode(run))
                    run = []
                out.append(self._id_to_special[i])
            else:
                run.append(i)
        if run:
            out.append(self.bpe.decode(run))
        return "".join(out)

    def decode_text(self, ids: Sequence[int]) -> str:
        """Decode ids, dropping every special token (the ``.text`` view)."""
        return self.bpe.decode([int(i) for i in ids if int(i) < self.n_base])

    # -- suppression sets (decoding) --------------------------------------
    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids for symbols that only appear in captions/annotations.

        Mirrors Whisper's standard blocklist: miscellaneous symbol tokens
        (music notes, parenthetical annotations) suppressed by default.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        miscellaneous = set("♩♪♫♬♭♮♯")

        result = set()
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1:
                    result.add(tokens[0])
                elif symbol in miscellaneous and tokens:
                    result.add(tokens[0])
        return tuple(sorted(result))


def get_tokenizer(
    multilingual: bool = True,
    *,
    num_languages: int = 99,
    language: Optional[str] = "en",
    task: str = "transcribe",
    ranks_path: Optional[str] = None,
) -> WhisperTokenizer:
    """Build a Whisper tokenizer.

    Loads real tiktoken ranks when available (``ranks_path`` argument, the
    WHISPER_IPA_TPU_TIKTOKEN env var, or a bundled assets file); otherwise
    falls back to the pure byte-level vocabulary, which preserves the
    special-token layout and round-trips all text (ids below 256 only).
    """
    path = _find_ranks_file(ranks_path)
    if path is not None:
        import hashlib

        ranks = load_tiktoken_ranks(path)
        n_base = max(ranks.values()) + 1
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        provenance = f"tiktoken:{digest}"
    else:
        ranks = byte_level_ranks()
        n_base = 50257 if multilingual else 50256
        provenance = "byte-fallback"
    if not multilingual:
        language = None
        task = "transcribe"
    return WhisperTokenizer(
        bpe=BPE(ranks),
        n_base=n_base,
        num_languages=num_languages,
        language=language,
        task=task,
        provenance=provenance,
    )
