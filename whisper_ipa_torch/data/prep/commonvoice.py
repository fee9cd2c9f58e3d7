"""CommonVoice IPA dataset conversion: path remapping, filtering, splits.

Converts per-language IPA JSON (from the G2P preprocessing stage) into the
pipeline schema with deterministic seeded test/val/train splits and
train-size variants. Behavioral parity with reference
scripts/data_prep/prepare_commonvoice_dataset.py (length filters 2..500,
NFC normalization, {root}/{locale}/clips/ remapping, seed-42 permutation
splits, 1k/2k/full per-language variants).
"""

from __future__ import annotations

import json
import os
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_LANGUAGES = ("ja", "pl", "mt", "hu", "fi", "el", "ta")


def load_language_data(input_dir: Path, locale: str) -> List[Dict]:
    input_dir = Path(input_dir)
    candidates = [
        input_dir / f"{locale}_train_ipa.json",
        input_dir / f"{locale}.json",
        input_dir / f"{locale}_train.json",
    ]
    for path in candidates:
        if path.exists():
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            print(f"  Loaded {len(data)} entries from {path.name}")
            return data
    raise FileNotFoundError(
        f"No data file found for locale '{locale}' in {input_dir}. "
        f"Tried: {[c.name for c in candidates]}"
    )


def remap_audio_path(entry: Dict, audio_root: Path, locale: str) -> str:
    filename = entry.get("path", "") or Path(entry.get("audio_path", "")).name
    if not filename:
        return ""
    return str(Path(audio_root) / locale / "clips" / filename)


def process_language(
    entries: List[Dict],
    audio_root: Path,
    locale: str,
    check_audio: bool = True,
) -> List[Dict]:
    """Remap paths, NFC-normalize, filter by length, check audio exists."""
    processed = []
    skipped_audio = 0
    skipped_ipa = 0
    for entry in entries:
        ipa = unicodedata.normalize(
            "NFC", entry.get("ipa_transcription", "").strip()
        )
        if not ipa or len(ipa) < 2 or len(ipa) > 500:
            skipped_ipa += 1
            continue
        audio_path = remap_audio_path(entry, audio_root, locale)
        if not audio_path or (check_audio and not os.path.isfile(audio_path)):
            skipped_audio += 1
            continue
        processed.append(
            {
                "audio_path": audio_path,
                "ipa_transcription": ipa,
                "speaker_id": "unknown",
                "dataset_source": "commonvoice",
                "language": locale,
            }
        )
    if skipped_audio:
        print(f"    Skipped {skipped_audio} entries (audio not found)")
    if skipped_ipa:
        print(f"    Skipped {skipped_ipa} entries (IPA empty/too short/too long)")
    return processed


def split_data(
    data: List[Dict],
    locale: str,
    test_per_lang: int,
    val_per_lang: int,
    rng: np.random.Generator,
) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """Seeded permutation split: test first, then val, remainder train."""
    n = len(data)
    indices = rng.permutation(n)
    test_n = min(test_per_lang, n)
    val_n = min(val_per_lang, n - test_n)
    if test_n < test_per_lang:
        print(
            f"    WARNING: {locale} has only {n} samples, "
            f"test capped at {test_n} (wanted {test_per_lang})"
        )
    if val_n < val_per_lang:
        print(f"    WARNING: {locale} val capped at {val_n} (wanted {val_per_lang})")

    test = [data[i] for i in indices[:test_n]]
    val = [data[i] for i in indices[test_n : test_n + val_n]]
    train = [data[i] for i in indices[test_n + val_n :]]
    for e in test:
        e["split"] = "test"
    for e in val:
        e["split"] = "val"
    for e in train:
        e["split"] = "train"
    return train, val, test


def save_json(data: List[Dict], path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)
    print(f"  Saved {len(data)} samples to {path}")


def prepare_commonvoice(
    input_dir: Path,
    audio_root: Path,
    output_dir: Path,
    languages: Sequence[str] = DEFAULT_LANGUAGES,
    train_per_lang: Sequence[int] = (1000, 2000),
    val_per_lang: int = 200,
    test_per_lang: int = 100,
    seed: int = 42,
    check_audio: bool = True,
) -> Dict[str, int]:
    """Full conversion: per-language processing, splits, size variants."""
    output_dir = Path(output_dir)
    rng = np.random.default_rng(seed)

    all_train: List[Dict] = []
    all_val: List[Dict] = []
    all_test: List[Dict] = []
    train_pools: Dict[str, List[Dict]] = {}

    for locale in languages:
        print(f"\nProcessing {locale}...")
        entries = load_language_data(input_dir, locale)
        processed = process_language(
            entries, audio_root, locale, check_audio=check_audio
        )
        train, val, test = split_data(
            processed, locale, test_per_lang, val_per_lang, rng
        )
        train_pools[locale] = train
        all_train.extend(train)
        all_val.extend(val)
        all_test.extend(test)

    save_json(all_train, output_dir / "commonvoice_train_full.json")
    save_json(all_val, output_dir / "commonvoice_val.json")
    save_json(all_test, output_dir / "commonvoice_test.json")

    for size in train_per_lang:
        variant: List[Dict] = []
        for locale, pool in train_pools.items():
            take = min(size, len(pool))
            sampled_idx = rng.choice(len(pool), size=take, replace=False)
            variant.extend(pool[i] for i in sampled_idx)
        save_json(variant, output_dir / f"commonvoice_train_{size}perlang.json")

    return {
        "train_full": len(all_train),
        "val": len(all_val),
        "test": len(all_test),
    }
