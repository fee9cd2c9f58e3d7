from .beam import beam_decode
from .decoding import (
    DecodingOptions,
    DecodingResult,
    apply_timestamp_rules,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    decode,
    detect_language,
    initial_tokens,
    rank_candidates,
    sequence_score,
)
from .medusa_tree import medusa_tree_decode
from .speculative import SpeculativeStats, speculative_decode
from .transcribe import chunk_audio, transcribe
from .word_timestamps import phone_timestamps, token_alignment

__all__ = [
    "DecodingOptions",
    "DecodingResult",
    "SpeculativeStats",
    "apply_timestamp_rules",
    "beam_decode",
    "build_blank_mask",
    "build_suppress_mask",
    "chunk_audio",
    "compression_ratio",
    "decode",
    "detect_language",
    "initial_tokens",
    "medusa_tree_decode",
    "phone_timestamps",
    "rank_candidates",
    "sequence_score",
    "speculative_decode",
    "token_alignment",
    "transcribe",
]
