"""Batch evaluation: aggregate PER/PFER over reference/hypothesis pairs.

Mirrors reference scripts/evaluate_ipa.py:346-378 (mean/std + raw scores).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .per import phone_error_rate
from .pfer import phone_feature_error_rate


def evaluate_batch(references: List[str], hypotheses: List[str]) -> Dict:
    assert len(references) == len(hypotheses), (
        "Reference and hypothesis lists must have same length"
    )
    per_scores = []
    pfer_scores = []
    for ref, hyp in zip(references, hypotheses):
        per_scores.append(phone_error_rate(ref, hyp))
        pfer_scores.append(phone_feature_error_rate(ref, hyp))
    return {
        "per": float(np.mean(per_scores)) if per_scores else 0.0,
        "pfer": float(np.mean(pfer_scores)) if pfer_scores else 0.0,
        "per_std": float(np.std(per_scores)) if per_scores else 0.0,
        "pfer_std": float(np.std(pfer_scores)) if pfer_scores else 0.0,
        "num_samples": len(references),
        "per_scores": per_scores,
        "pfer_scores": pfer_scores,
    }
