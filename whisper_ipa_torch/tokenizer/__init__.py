"""Whisper BPE tokenizer: a copy of ``whisper_ipa_tpu.tokenizer``. It
reads the same rank file (``WHISPER_IPA_TPU_TIKTOKEN``), so both packages
produce the same ids."""

from .bpe import BPE, byte_level_ranks, load_tiktoken_ranks
from .whisper_tokenizer import (
    LANGUAGES,
    LANGUAGES_V3,
    WhisperTokenizer,
    get_tokenizer,
)

__all__ = [
    "BPE",
    "byte_level_ranks",
    "load_tiktoken_ranks",
    "LANGUAGES",
    "LANGUAGES_V3",
    "WhisperTokenizer",
    "get_tokenizer",
]
