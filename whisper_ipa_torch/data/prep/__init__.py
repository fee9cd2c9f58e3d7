"""Corpus preparation: TIMIT / METU / OGI converters, CommonVoice G2P
preprocessing and splits, NFC verification, and the zero-shot test set with
its inter-annotator agreement. A copy of ``whisper_ipa_tpu.data.prep`` with
the same ``__all__``; the TSV/CSV and Excel readers need neither pandas nor
openpyxl (``tables``, ``utils.xlsx``)."""

from .audio_meta import get_audio_duration
from .commonvoice import prepare_commonvoice
from .corpora import (
    combine_datasets,
    labels_to_ipa,
    parse_phn_file,
    parse_ptl_file,
    prepare_metu,
    prepare_ogi,
    prepare_timit,
)
from .g2p import SUPPORTED_LANGUAGES, text_to_ipa
from .phonesets import (
    METUBET_TO_IPA,
    OGI_ARPABET_TO_IPA,
    TIMIT_ARPABET_TO_IPA,
)
from .preprocess import analyze_language, create_datasets, process_language
from .verify import analyze_dataset, apply_normalization, check_normalization
from .zeroshot import build_zeroshot_json, compute_iaa

__all__ = [
    "METUBET_TO_IPA",
    "OGI_ARPABET_TO_IPA",
    "SUPPORTED_LANGUAGES",
    "TIMIT_ARPABET_TO_IPA",
    "analyze_dataset",
    "analyze_language",
    "apply_normalization",
    "build_zeroshot_json",
    "check_normalization",
    "combine_datasets",
    "compute_iaa",
    "create_datasets",
    "get_audio_duration",
    "labels_to_ipa",
    "parse_phn_file",
    "parse_ptl_file",
    "prepare_commonvoice",
    "prepare_metu",
    "prepare_ogi",
    "prepare_timit",
    "process_language",
    "text_to_ipa",
]
