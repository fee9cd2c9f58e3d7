"""Dataset NFC-normalization audit and fixer.

(reference scripts/data_prep/verify_ipa_normalization.py)
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def check_normalization(text: str) -> bool:
    return unicodedata.normalize("NFC", text) == text


def analyze_dataset(json_path: Path) -> Tuple[bool, List[Dict]]:
    """Report which entries need NFC normalization."""
    json_path = Path(json_path)
    with open(json_path) as f:
        data = json.load(f)

    changes = []
    for i, entry in enumerate(data):
        ipa = entry.get("ipa_transcription", "")
        if not check_normalization(ipa):
            changes.append(
                {
                    "index": i,
                    "original": ipa,
                    "normalized": unicodedata.normalize("NFC", ipa),
                    "utterance_id": entry.get(
                        "utterance_id", entry.get("speaker_id", "unknown")
                    ),
                }
            )

    total = len(data)
    ok = total - len(changes)
    print(f"\nAnalyzing: {json_path.name}")
    print(f"Total samples: {total}")
    if total:
        print(f"Already normalized: {ok} ({ok / total * 100:.1f}%)")
        print(
            f"Needs normalization: {len(changes)} "
            f"({len(changes) / total * 100:.1f}%)"
        )
    for change in changes[:5]:
        print(
            f"  Sample {change['index']} ({change['utterance_id']}): "
            f"'{change['original']}' -> '{change['normalized']}'"
        )
    return len(changes) > 0, changes


def apply_normalization(
    json_path: Path, output_path: Optional[Path] = None
) -> Path:
    """Write an NFC-normalized copy (or a *_normalized.json sibling)."""
    json_path = Path(json_path)
    if output_path is None:
        output_path = json_path.parent / f"{json_path.stem}_normalized.json"
    with open(json_path) as f:
        data = json.load(f)
    for entry in data:
        if "ipa_transcription" in entry:
            entry["ipa_transcription"] = unicodedata.normalize(
                "NFC", entry["ipa_transcription"]
            )
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)
    print(f"Normalized dataset saved to: {output_path}")
    return Path(output_path)
