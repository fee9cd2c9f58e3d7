"""Zero-shot test set assembly + inter-annotator agreement (IAA).

Parses both annotators' Excel sheets and multipa's test_data.csv,
cross-references to identify the gold annotator, indexes WAVs, and emits
zeroshot_test.json. The IAA computation (PER / PFER-Hamming / PFER-Cosine in
both directions, matched against the paper's 19.6%) is the strongest
correctness oracle for the metric implementation. Behavioral parity with
reference scripts/parse_zeroshot_test.py and scripts/compute_iaa.py.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ...metrics import (
    normalize_ipa_for_comparison,
    phone_error_rate,
    phone_feature_error_rate,
    phone_feature_error_rate_cosine,
)
from ...utils.xlsx import read_xlsx_records
from .tables import isna, iterrows, read_table

PAPER_IAA = 19.6  # Taguchi et al. reported inter-annotator PFER

# Poor-quality IDs per annotator (from paper/sheet inspection)
POOR_QUALITY_ARIGA = {41, 75}
POOR_QUALITY_HAMANISHI = {41, 80}


def normalize_ipa(text) -> Optional[str]:
    if not isinstance(text, str):
        return None
    text = unicodedata.normalize("NFC", text).strip()
    if not text or text == "?":
        return None
    return text


def parse_annotator_excel(path: Path, poor_quality_ids: Set[int]) -> Dict[int, Dict]:
    """Excel sheet -> {id: {ipa, poor_quality, elapsed_time}}, read by
    ``utils.xlsx`` (numbers as floats, text as str, blanks as None)."""
    entries: Dict[int, Dict] = {}
    for row in read_xlsx_records(str(path)):
        raw_id = row.get("ID")
        if isna(raw_id):
            continue
        try:
            entry_id = int(raw_id)
        except (ValueError, TypeError):
            continue
        ipa = normalize_ipa(
            str(row.get("IPA")) if not isna(row.get("IPA")) else None
        )
        elapsed = row.get("Elapsed Time (sec)")
        try:
            elapsed = float(elapsed) if not isna(elapsed) else None
        except (ValueError, TypeError):
            elapsed = None
        entries[entry_id] = {
            "ipa": ipa,
            "poor_quality": entry_id in poor_quality_ids,
            "elapsed_time": elapsed,
        }
    return entries


def parse_test_data_csv(path: Path) -> Dict[int, Dict]:
    """multipa test_data.csv -> {id: {ipa, done}}. Cells are typed as
    ``pandas.read_csv`` types them (``data.prep.tables``), so an ``ID`` of
    ``41.0`` or a ``Done`` of ``1.0`` in a numeric column reads as a float
    that ``int`` takes, and the same text in a text column does not."""
    _, rows = read_table(path, sep=",")
    entries: Dict[int, Dict] = {}
    for row in iterrows(rows):
        raw_id = row.get("ID")
        if isna(raw_id):
            continue
        try:
            entry_id = int(raw_id)
        except (ValueError, TypeError):
            continue
        try:
            done = int(row.get("Done")) == 1
        except (ValueError, TypeError):
            done = False
        entries[entry_id] = {
            "ipa": normalize_ipa(
                str(row.get("IPA")) if not isna(row.get("IPA")) else None
            ),
            "done": done,
        }
    return entries


def build_wav_index(wav_dir: Path) -> Dict[int, str]:
    """'{id}_{hash}.wav' files -> {id: absolute path} ('Copy of' skipped)."""
    index: Dict[int, str] = {}
    for f in Path(wav_dir).iterdir():
        if f.suffix.lower() != ".wav" or f.name.startswith("Copy of"):
            continue
        try:
            index[int(f.stem.split("_", 1)[0])] = str(f.resolve())
        except (ValueError, IndexError):
            continue
    return index


def cross_reference(
    test_csv: Dict[int, Dict],
    ariga: Dict[int, Dict],
    hamanishi: Dict[int, Dict],
) -> Tuple[int, int, int]:
    """Count exact (space-insensitive) matches per annotator."""
    a_match = h_match = total = 0
    for entry_id, csv_entry in test_csv.items():
        csv_ipa = csv_entry["ipa"]
        if csv_ipa is None:
            continue
        clean = csv_ipa.replace(" ", "")
        total += 1
        a = ariga.get(entry_id, {}).get("ipa")
        if a is not None and a.replace(" ", "") == clean:
            a_match += 1
        h = hamanishi.get(entry_id, {}).get("ipa")
        if h is not None and h.replace(" ", "") == clean:
            h_match += 1
    return a_match, h_match, total


def build_zeroshot_json(
    ariga_xlsx: Path,
    hamanishi_xlsx: Path,
    test_data_csv: Path,
    wav_dir: Path,
    output_path: Path,
) -> List[Dict]:
    """Full parse + cross-reference + emission."""
    ariga = parse_annotator_excel(ariga_xlsx, POOR_QUALITY_ARIGA)
    hamanishi = parse_annotator_excel(hamanishi_xlsx, POOR_QUALITY_HAMANISHI)
    test_csv = parse_test_data_csv(test_data_csv)
    wav_index = build_wav_index(wav_dir)

    a_match, h_match, total = cross_reference(test_csv, ariga, hamanishi)
    print(
        f"Cross-reference: Ariga {a_match}/{total}, "
        f"Hamanishi {h_match}/{total}"
    )
    if a_match > h_match:
        gold_annotator = "ariga"
    elif h_match > a_match:
        gold_annotator = "hamanishi"
    else:
        gold_annotator = "unknown"
    print(f"Gold annotator: {gold_annotator}")

    output: List[Dict] = []
    for entry_id in sorted(set(ariga) | set(hamanishi)):
        a = ariga.get(entry_id, {})
        h = hamanishi.get(entry_id, {})
        if a.get("ipa") is None and h.get("ipa") is None:
            continue
        has_both = a.get("ipa") is not None and h.get("ipa") is not None
        usable = (
            has_both
            and not a.get("poor_quality", False)
            and not h.get("poor_quality", False)
        )
        gold_ipa = {
            "ariga": a.get("ipa"),
            "hamanishi": h.get("ipa"),
            "unknown": None,
        }[gold_annotator]
        output.append(
            {
                "id": entry_id,
                "audio_path": wav_index.get(entry_id),
                "ipa_ariga": a.get("ipa"),
                "ipa_hamanishi": h.get("ipa"),
                "ipa_test_csv": test_csv.get(entry_id, {}).get("ipa"),
                "poor_quality_ariga": a.get("poor_quality", False),
                "poor_quality_hamanishi": h.get("poor_quality", False),
                "has_both_annotators": has_both,
                "usable_for_iaa": usable,
                "gold_annotator": gold_annotator,
                "gold_ipa": gold_ipa,
                "language": None,
                "dataset_source": "multipa_zeroshot_test",
            }
        )

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(output, f, ensure_ascii=False, indent=2)
    print(
        f"Wrote {len(output)} entries "
        f"({sum(1 for r in output if r['usable_for_iaa'])} usable for IAA) "
        f"to {output_path}"
    )
    return output


# -- IAA ------------------------------------------------------------------

def compute_pair_metrics(refs: List[str], hyps: List[str]) -> Dict:
    """PER + both PFER variants with stds (reference compute_metrics)."""
    per = [phone_error_rate(r, h) for r, h in zip(refs, hyps)]
    pfer_h = [phone_feature_error_rate(r, h) for r, h in zip(refs, hyps)]
    pfer_c = [
        phone_feature_error_rate_cosine(r, h) for r, h in zip(refs, hyps)
    ]
    return {
        "per": float(np.mean(per)),
        "per_std": float(np.std(per)),
        "pfer_hamming": float(np.mean(pfer_h)),
        "pfer_hamming_std": float(np.std(pfer_h)),
        "pfer_cosine": float(np.mean(pfer_c)),
        "pfer_cosine_std": float(np.std(pfer_c)),
        "per_scores": per,
        "pfer_h_scores": pfer_h,
        "pfer_c_scores": pfer_c,
    }


def compute_iaa(zeroshot_json: Path) -> Dict:
    """Both-direction IAA; identifies the combination nearest the paper's
    19.6% (the reference's metric-validation oracle)."""
    with open(zeroshot_json, encoding="utf-8") as f:
        data = json.load(f)
    pairs = [e for e in data if e["usable_for_iaa"]]
    print(f"Usable pairs: {len(pairs)}")

    ariga = [normalize_ipa_for_comparison(e["ipa_ariga"]) for e in pairs]
    hama = [normalize_ipa_for_comparison(e["ipa_hamanishi"]) for e in pairs]

    # sanity: self-comparison must be exactly zero
    for a in ariga[:5]:
        assert phone_error_rate(a, a) == 0.0
        assert phone_feature_error_rate(a, a) == 0.0

    dir_a = compute_pair_metrics(ariga, hama)
    dir_b = compute_pair_metrics(hama, ariga)

    candidates = [
        ("Ariga-ref, PFER-Hamming", dir_a["pfer_hamming"]),
        ("Ariga-ref, PFER-Cosine", dir_a["pfer_cosine"]),
        ("Hamanishi-ref, PFER-Hamming", dir_b["pfer_hamming"]),
        ("Hamanishi-ref, PFER-Cosine", dir_b["pfer_cosine"]),
    ]
    best = min(candidates, key=lambda x: abs(x[1] - PAPER_IAA))
    print(f"Best match to paper {PAPER_IAA}%: {best[0]} = {best[1]:.1f}%")

    return {
        "ariga_ref": dir_a,
        "hamanishi_ref": dir_b,
        "candidates": candidates,
        "best": best,
        "paper_iaa": PAPER_IAA,
        "num_pairs": len(pairs),
    }
