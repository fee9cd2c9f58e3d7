"""Error analysis: phone alignments, confusion counts, score distributions.

Research tooling layered on the metric core: align reference/hypothesis
phone sequences (Levenshtein backtrace), tally substitution/insertion/
deletion counts per phone, and summarize PER/PFER distributions — the
analysis the reference's experiments did by eyeballing transcripts.
The PyTorch package's copy of ``whisper_ipa_tpu/metrics/analysis.py``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .per import phone_error_rate
from .pfer import phone_feature_error_rate
from .segment import normalize_ipa_for_comparison, tokenize_ipa

Op = Tuple[str, str, str]  # (operation, ref_phone, hyp_phone)


def align_phones(ref: Sequence[str], hyp: Sequence[str]) -> List[Op]:
    """Levenshtein alignment path: ops are match/sub/ins/del."""
    m, n = len(ref), len(hyp)
    D = np.zeros((m + 1, n + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            D[i, j] = min(
                D[i - 1, j] + 1,
                D[i, j - 1] + 1,
                D[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
            )
    ops: List[Op] = []
    i, j = m, n
    while i > 0 or j > 0:
        if (
            i > 0
            and j > 0
            and D[i, j] == D[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
        ):
            ops.append(
                (
                    "match" if ref[i - 1] == hyp[j - 1] else "sub",
                    ref[i - 1],
                    hyp[j - 1],
                )
            )
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append(("del", ref[i - 1], ""))
            i -= 1
        else:
            ops.append(("ins", "", hyp[j - 1]))
            j -= 1
    return ops[::-1]


def confusion_analysis(
    references: Sequence[str], hypotheses: Sequence[str]
) -> Dict:
    """Aggregate error analysis over a corpus of (ref, hyp) pairs."""
    substitutions: Counter = Counter()
    insertions: Counter = Counter()
    deletions: Counter = Counter()
    per_scores: List[float] = []
    pfer_scores: List[float] = []
    n_match = n_total_ref = 0

    for ref_text, hyp_text in zip(references, hypotheses):
        ref_text = normalize_ipa_for_comparison(ref_text)
        hyp_text = normalize_ipa_for_comparison(hyp_text)
        ref = tokenize_ipa(ref_text)
        hyp = tokenize_ipa(hyp_text)
        n_total_ref += len(ref)
        for op, r, h in align_phones(ref, hyp):
            if op == "match":
                n_match += 1
            elif op == "sub":
                substitutions[(r, h)] += 1
            elif op == "ins":
                insertions[h] += 1
            elif op == "del":
                deletions[r] += 1
        per_scores.append(phone_error_rate(ref_text, hyp_text))
        pfer_scores.append(phone_feature_error_rate(ref_text, hyp_text))

    per_arr = np.asarray(per_scores) if per_scores else np.zeros(1)
    pfer_arr = np.asarray(pfer_scores) if pfer_scores else np.zeros(1)
    return {
        "num_pairs": len(per_scores),
        "phone_accuracy": n_match / max(n_total_ref, 1),
        "top_substitutions": substitutions.most_common(20),
        "top_insertions": insertions.most_common(10),
        "top_deletions": deletions.most_common(10),
        "per": {
            "mean": float(per_arr.mean()),
            "median": float(np.median(per_arr)),
            "p90": float(np.percentile(per_arr, 90)),
            "worst": float(per_arr.max()),
        },
        "pfer": {
            "mean": float(pfer_arr.mean()),
            "median": float(np.median(pfer_arr)),
            "p90": float(np.percentile(pfer_arr, 90)),
            "worst": float(pfer_arr.max()),
        },
        "per_scores": per_scores,
        "pfer_scores": pfer_scores,
    }


def print_confusion_report(report: Dict) -> None:
    print(f"Pairs: {report['num_pairs']}")
    print(f"Phone accuracy: {report['phone_accuracy'] * 100:.1f}%")
    print(
        f"PER  mean {report['per']['mean']:.1f}% median "
        f"{report['per']['median']:.1f}% p90 {report['per']['p90']:.1f}%"
    )
    print(
        f"PFER mean {report['pfer']['mean']:.1f}% median "
        f"{report['pfer']['median']:.1f}% p90 {report['pfer']['p90']:.1f}%"
    )
    print("\nTop substitutions (ref -> hyp):")
    for (r, h), count in report["top_substitutions"][:15]:
        print(f"  {r!r:>8} -> {h!r:<8} x{count}")
    print("\nTop deletions:")
    for r, count in report["top_deletions"][:8]:
        print(f"  {r!r:>8} x{count}")
    print("\nTop insertions:")
    for h, count in report["top_insertions"][:8]:
        print(f"  {h!r:>8} x{count}")
