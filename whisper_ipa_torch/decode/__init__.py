from .decoding import (
    DecodingOptions,
    DecodingResult,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    decode,
    initial_tokens,
    sequence_score,
)

__all__ = [
    "DecodingOptions",
    "DecodingResult",
    "build_blank_mask",
    "build_suppress_mask",
    "compression_ratio",
    "decode",
    "initial_tokens",
    "sequence_score",
]
