"""Phone Error Rate: Levenshtein distance over phone segments.

PER = edit_distance(ref_phones, hyp_phones) / len(ref_phones) * 100
(reference scripts/evaluate_ipa.py:80-105). The PyTorch package's copy of
``whisper_ipa_tpu/metrics/per.py`` with the vectorized NumPy DP only (the
native C++ core is not ported).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .segment import tokenize_ipa

def _levenshtein_numpy(a: Sequence[int], b: Sequence[int]) -> int:
    """Row-vectorized Levenshtein on integer id sequences."""
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    a_arr = np.asarray(a, dtype=np.int64)
    b_arr = np.asarray(b, dtype=np.int64)
    prev = np.arange(n + 1, dtype=np.int64)
    idx = np.arange(1, n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (b_arr != a_arr[i - 1])
        ins_del = np.minimum(prev[1:] + 1, sub)
        # cur[j] = min(ins_del[j], cur[j-1] + 1). Unrolling the left-to-right
        # chain: cur[j] = j + min(cur[0], min_{k<=j}(ins_del[k] - k)), which a
        # prefix-min (np.minimum.accumulate) computes without a Python loop.
        cur[1:] = idx + np.minimum(
            np.minimum.accumulate(ins_del - idx), cur[0]
        )
        prev = cur
    return int(prev[n])


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two sequences (of hashables)."""
    # map to integer ids for the numeric cores
    symtab = {}
    def ids(seq):
        out = []
        for s in seq:
            if s not in symtab:
                symtab[s] = len(symtab)
            out.append(symtab[s])
        return out

    ia, ib = ids(a), ids(b)
    return _levenshtein_numpy(ia, ib)


def phone_error_rate(reference: str, hypothesis: str) -> float:
    """PER as a percentage of the reference length."""
    ref_phones: List[str] = tokenize_ipa(reference)
    hyp_phones: List[str] = tokenize_ipa(hypothesis)
    if len(ref_phones) == 0:
        return 0.0 if len(hyp_phones) == 0 else 100.0
    distance = edit_distance(ref_phones, hyp_phones)
    return (distance / len(ref_phones)) * 100.0
