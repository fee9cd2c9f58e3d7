"""Phonetic metrics (PER, PFER): copies of ``whisper_ipa_tpu.metrics``
with the NumPy edit-distance cores only."""

from .evaluate import evaluate_batch
from .features import (
    FEATURE_NAMES,
    NUM_FEATURES,
    get_phone_features,
    known_phone,
    phone_to_vector,
)
from .per import edit_distance, phone_error_rate
from .pfer import (
    PFERCalculator,
    PFERCalculatorCosine,
    phone_feature_error_rate,
    phone_feature_error_rate_cosine,
)
from .segment import normalize_ipa_for_comparison, tokenize_ipa

__all__ = [
    "FEATURE_NAMES",
    "NUM_FEATURES",
    "PFERCalculator",
    "PFERCalculatorCosine",
    "edit_distance",
    "evaluate_batch",
    "get_phone_features",
    "known_phone",
    "normalize_ipa_for_comparison",
    "phone_error_rate",
    "phone_feature_error_rate",
    "phone_feature_error_rate_cosine",
    "phone_to_vector",
    "tokenize_ipa",
]
