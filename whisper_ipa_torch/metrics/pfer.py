"""Phone Feature Error Rate (PFER): feature-weighted edit distance.

Two variants, matching the reference (scripts/evaluate_ipa.py:108-287):

  - Hamming ("the validated paper metric"): DP edit distance where
    substitution costs feature-mismatch-count / 24 and insertion/deletion
    cost 1. Equal phones cost 0.
  - Cosine (Taguchi's LPhD_combined): when the two phones' feature vectors
    are equal the cell inherits the diagonal; otherwise ALL three operations
    share the penalty 1 - cos_sim(ref_feat, hyp_feat) and the cell is
    min(left, up, diag) + penalty.

Both DPs are vectorized: feature vectors are precomputed per unique phone
and the substitution-cost matrix is one (m, n) tensor op; the remaining
O(m·n) recurrence runs row-vectorized (anti-diagonal dependency removed via
the Hamming structure). The PyTorch package's copy of
``whisper_ipa_tpu/metrics/pfer.py`` without the native C++ core.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .features import NUM_FEATURES, get_phone_features
from .segment import tokenize_ipa


def _phone_matrix(phones: List[str]) -> np.ndarray:
    """(len(phones), 24) float matrix of feature vectors."""
    if not phones:
        return np.zeros((0, NUM_FEATURES), dtype=np.float64)
    return np.stack([get_phone_features(p).astype(np.float64) for p in phones])


def _substitution_costs_hamming(
    ref_phones: List[str], hyp_phones: List[str]
) -> np.ndarray:
    """(m, n) matrix: mismatching-feature count / 24; 0 where phones equal."""
    ref_feats = _phone_matrix(ref_phones)
    hyp_feats = _phone_matrix(hyp_phones)
    mismatches = (ref_feats[:, None, :] != hyp_feats[None, :, :]).sum(axis=-1)
    cost = mismatches.astype(np.float64) / NUM_FEATURES
    ref_arr = np.array(ref_phones, dtype=object)
    hyp_arr = np.array(hyp_phones, dtype=object)
    cost[ref_arr[:, None] == hyp_arr[None, :]] = 0.0
    return cost


def _weighted_dp(sub_cost: np.ndarray) -> float:
    """Edit-distance DP: ins/del cost 1, substitution cost from sub_cost."""
    m, n = sub_cost.shape
    prev = np.arange(n + 1, dtype=np.float64)
    idx = np.arange(1, n + 1, dtype=np.float64)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.float64)
        cur[0] = float(i)
        best = np.minimum(prev[1:] + 1.0, prev[:-1] + sub_cost[i - 1])
        # fold in the left-to-right insertion chain via prefix-min
        cur[1:] = idx + np.minimum(
            np.minimum.accumulate(best - idx), cur[0]
        )
        prev = cur
    return float(prev[n])


def phone_feature_error_rate(reference: str, hypothesis: str) -> float:
    """PFER (Hamming variant) as a percentage of the reference length."""
    ref_phones = tokenize_ipa(reference)
    hyp_phones = tokenize_ipa(hypothesis)
    if len(ref_phones) == 0:
        return 0.0 if len(hyp_phones) == 0 else 100.0
    sub_cost = _substitution_costs_hamming(ref_phones, hyp_phones)
    dist = _weighted_dp(sub_cost)
    return (dist / len(ref_phones)) * 100.0


# -- cosine variant -------------------------------------------------------

def _cosine_penalties(
    ref_feats: np.ndarray, hyp_feats: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Penalty matrix (1 - cos_sim) and equality mask, both (m, n)."""
    norms_r = np.linalg.norm(ref_feats, axis=1)
    norms_h = np.linalg.norm(hyp_feats, axis=1)
    denom = norms_r[:, None] * norms_h[None, :]
    denom = np.where(denom == 0.0, 0.001, denom)
    cos_sim = (ref_feats @ hyp_feats.T) / denom
    penalty = 1.0 - cos_sim
    equal = np.all(
        ref_feats[:, None, :] == hyp_feats[None, :, :], axis=-1
    )
    return penalty, equal


def phone_feature_error_rate_cosine(reference: str, hypothesis: str) -> float:
    """PFER (cosine variant), matching Taguchi's LPhD_combined algorithm."""
    ref_phones = tokenize_ipa(reference)
    hyp_phones = tokenize_ipa(hypothesis)
    if len(ref_phones) == 0:
        return 0.0 if len(hyp_phones) == 0 else 100.0

    ref_feats = _phone_matrix(ref_phones)
    hyp_feats = _phone_matrix(hyp_phones)
    penalty, equal = _cosine_penalties(ref_feats, hyp_feats)

    m, n = len(ref_phones), len(hyp_phones)
    dp = np.zeros((m + 1, n + 1), dtype=np.float64)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        row_pen = penalty[i - 1]
        row_eq = equal[i - 1]
        for j in range(1, n + 1):
            if row_eq[j - 1]:
                dp[i, j] = dp[i - 1, j - 1]
            else:
                dp[i, j] = (
                    min(dp[i, j - 1], dp[i - 1, j], dp[i - 1, j - 1])
                    + row_pen[j - 1]
                )
    dist = float(dp[m, n])
    return (dist / len(ref_phones)) * 100.0


# -- module-level convenience mirroring the reference API ------------------

class PFERCalculator:
    """Hamming-variant calculator (reference-compatible surface)."""

    num_features = NUM_FEATURES

    def get_phone_features(self, phone: str) -> np.ndarray:
        return get_phone_features(phone).astype(np.float64)

    def feature_distance(self, phone1: str, phone2: str) -> float:
        if phone1 == phone2:
            return 0.0
        f1 = self.get_phone_features(phone1)
        f2 = self.get_phone_features(phone2)
        return float(np.sum(f1 != f2)) / self.num_features

    def phone_feature_error_rate(self, reference: str, hypothesis: str) -> float:
        return phone_feature_error_rate(reference, hypothesis)


class PFERCalculatorCosine:
    """Cosine-variant calculator (reference-compatible surface)."""

    num_features = NUM_FEATURES

    def get_phone_features(self, phone: str) -> np.ndarray:
        return get_phone_features(phone).astype(np.float64)

    def cosine_distance(self, feat1: np.ndarray, feat2: np.ndarray) -> float:
        denom = np.linalg.norm(feat1) * np.linalg.norm(feat2)
        if denom == 0:
            denom = 0.001
        return 1.0 - float(np.dot(feat1, feat2)) / denom

    def phone_feature_error_rate(self, reference: str, hypothesis: str) -> float:
        return phone_feature_error_rate_cosine(reference, hypothesis)
