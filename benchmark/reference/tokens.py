"""Whisper's special-token layout, from the published multilingual
vocabulary: 50257 text tokens (GPT-2's byte-level BPE), then EOT, SOT,
one token a language, translate, transcribe, start-of-LM, start-of-
previous, no-speech, no-timestamps and the timestamps. A 51866-token
vocabulary (large-v3) holds 100 languages, a 51865-token one 99.
"""

from __future__ import annotations

from typing import Dict, List

N_TEXT = 50257


def special_ids(n_vocab: int) -> Dict[str, int]:
    n_lang = 99 + (n_vocab - 51865)
    eot = N_TEXT
    sot = eot + 1
    after = sot + 1 + n_lang
    return {
        "eot": eot,
        "sot": sot,
        "en": sot + 1,  # English is the first language
        "translate": after,
        "transcribe": after + 1,
        "sot_lm": after + 2,
        "sot_prev": after + 3,
        "no_speech": after + 4,
        "no_timestamps": after + 5,
        "timestamp_begin": after + 6,
    }


def transcribe_prefix(n_vocab: int) -> List[int]:
    """<|startoftranscript|><|en|><|transcribe|><|notimestamps|>"""
    s = special_ids(n_vocab)
    return [s["sot"], s["en"], s["transcribe"], s["no_timestamps"]]
