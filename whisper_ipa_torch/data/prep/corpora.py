"""Aligned-corpus preparation: TIMIT, METU Turkish, OGI Spelled Speech.

Walks each corpus layout, parses time-aligned phone label files, converts
labels to IPA via the phoneset tables, and emits the pipeline's JSON dataset
schema. Behavioral parity with reference
scripts/data_prep/prepare_{timit_dataset,metu_turkish,ogi_spelled}.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .phonesets import (
    METU_NONSPEECH,
    METUBET_TO_IPA,
    OGI_ARPABET_TO_IPA,
    OGI_NONSPEECH,
    TIMIT_ARPABET_TO_IPA,
    TIMIT_NONSPEECH,
)

Alignment = List[Tuple[int, int, str]]


def parse_phn_file(path: Path, lowercase: bool = True) -> Alignment:
    """TIMIT/METU .phn: ``start end label`` per line."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 3:
                label = parts[2].lower() if lowercase else parts[2]
                out.append((int(parts[0]), int(parts[1]), label))
    return out


def parse_ptl_file(path: Path) -> Alignment:
    """OGI .ptl: header lines until 'END OF HEADER', then ms-aligned labels."""
    out = []
    in_header = True
    with open(path) as f:
        for line in f:
            line = line.strip()
            if in_header:
                if line == "END OF HEADER":
                    in_header = False
                continue
            parts = line.split()
            if len(parts) >= 3:
                out.append((int(parts[0]), int(parts[1]), parts[2].lower()))
    return out


def labels_to_ipa(alignment: Alignment, table: Dict[str, str]) -> str:
    """Map labels through the table; empty mappings and unknowns dropped."""
    chars = []
    for _, _, label in alignment:
        ipa = table.get(label)
        if ipa is None:
            print(f"Warning: Unknown phoneme '{label}' - skipping")
        elif ipa:
            chars.append(ipa)
    return "".join(chars)


def _write_json(dataset: List[Dict], output_file: Path) -> None:
    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    with open(output_file, "w", encoding="utf-8") as f:
        json.dump(dataset, f, ensure_ascii=False, indent=2)


def prepare_timit(
    timit_root: Path, output_file: Path, split: str = "TRAIN"
) -> List[Dict]:
    """TIMIT {TRAIN,TEST}/DR*/speaker/*.WAV + .PHN (+ .TXT) -> JSON."""
    timit_root = Path(timit_root)
    split_dir = timit_root / split
    if not split_dir.exists():
        raise ValueError(f"Split directory not found: {split_dir}")

    dataset: List[Dict] = []
    for dr_dir in sorted(split_dir.glob("DR*")):
        if not dr_dir.is_dir():
            continue
        for speaker_dir in sorted(dr_dir.iterdir()):
            if not speaker_dir.is_dir():
                continue
            for wav_file in sorted(speaker_dir.glob("*.WAV")):
                phn_file = wav_file.with_suffix(".PHN")
                txt_file = wav_file.with_suffix(".TXT")
                if not phn_file.exists():
                    print(f"Warning: Missing .PHN file for {wav_file}")
                    continue
                alignment = parse_phn_file(phn_file)
                ipa = labels_to_ipa(alignment, TIMIT_ARPABET_TO_IPA)

                orthographic = ""
                if txt_file.exists():
                    parts = txt_file.read_text().strip().split(maxsplit=2)
                    if len(parts) == 3:
                        orthographic = parts[2]

                dataset.append(
                    {
                        "audio_path": str(wav_file.absolute()),
                        "ipa_transcription": ipa,
                        "orthographic_text": orthographic,
                        "speaker_id": speaker_dir.name,
                        "dialect_region": dr_dir.name,
                        "utterance_id": wav_file.stem,
                        "phoneme_count": len(
                            [
                                p
                                for p in alignment
                                if p[2] not in TIMIT_NONSPEECH
                            ]
                        ),
                        "arpabet_phonemes": [p[2] for p in alignment],
                    }
                )

    _write_json(dataset, output_file)
    print(f"\n{split} Dataset Statistics:")
    print(f"  Total utterances: {len(dataset)}")
    print(f"  Output file: {output_file}")
    return dataset


def prepare_metu(metu_root: Path, output_file: Path) -> List[Dict]:
    """METU Turkish: data/speech-text/s*/ wavs + data/alignments/s*/ phns."""
    metu_root = Path(metu_root)
    speech_dir = metu_root / "data" / "speech-text"
    align_dir = metu_root / "data" / "alignments"
    if not speech_dir.exists():
        raise ValueError(f"Speech-text directory not found: {speech_dir}")
    if not align_dir.exists():
        raise ValueError(f"Alignments directory not found: {align_dir}")

    dataset: List[Dict] = []
    for speaker_dir in sorted(speech_dir.glob("s*")):
        if not speaker_dir.is_dir():
            continue
        speaker_id = speaker_dir.name
        align_speaker = align_dir / speaker_id
        if not align_speaker.exists():
            print(f"Warning: No alignment directory for speaker {speaker_id}")
            continue
        for wav_file in sorted(speaker_dir.glob("*.wav")):
            phn_file = align_speaker / f"{wav_file.stem}.phn"
            txt_file = wav_file.with_suffix(".txt")
            if not phn_file.exists():
                print(f"Warning: Missing .phn file for {wav_file}")
                continue
            alignment = parse_phn_file(phn_file, lowercase=False)
            ipa = labels_to_ipa(alignment, METUBET_TO_IPA)
            orthographic = (
                txt_file.read_text(encoding="utf-8").strip()
                if txt_file.exists()
                else ""
            )
            dataset.append(
                {
                    "audio_path": str(wav_file.absolute()),
                    "ipa_transcription": ipa,
                    "orthographic_text": orthographic,
                    "speaker_id": speaker_id,
                    "utterance_id": wav_file.stem,
                    "phoneme_count": len(
                        [p for p in alignment if p[2] not in METU_NONSPEECH]
                    ),
                    "metubet_phonemes": [p[2] for p in alignment],
                    "language": "turkish",
                }
            )

    _write_json(dataset, output_file)
    print("\nMETU Turkish Dataset Statistics:")
    print(f"  Total utterances: {len(dataset)}")
    print(f"  Output file: {output_file}")
    return dataset


def prepare_ogi(ogi_root: Path, output_file: Path) -> List[Dict]:
    """OGI Spelled Speech: handlabl/**/*.ptl matched to speech/**/*.wav."""
    ogi_root = Path(ogi_root)
    speech_root = ogi_root / "speech"
    handlabl_root = ogi_root / "handlabl"
    if not speech_root.exists():
        raise ValueError(f"Speech directory not found: {speech_root}")
    if not handlabl_root.exists():
        raise ValueError(f"Handlabl directory not found: {handlabl_root}")

    dataset: List[Dict] = []
    for ptl_file in sorted(handlabl_root.rglob("*.ptl")):
        rel = ptl_file.relative_to(handlabl_root)
        wav_file = speech_root / rel.with_suffix(".wav")
        if not wav_file.exists():
            print(f"Warning: Missing .wav file for {ptl_file}")
            continue
        try:
            alignment = parse_ptl_file(ptl_file)
        except Exception as e:
            print(f"Warning: Error parsing {ptl_file}: {e}")
            continue
        ipa = labels_to_ipa(alignment, OGI_ARPABET_TO_IPA)
        parts = rel.parts
        dataset.append(
            {
                "audio_path": str(wav_file.absolute()),
                "ipa_transcription": ipa,
                "orthographic_text": "",
                "corpus_type": parts[0] if len(parts) > 0 else "unknown",
                "subset_id": parts[1] if len(parts) > 1 else "unknown",
                "utterance_id": ptl_file.stem,
                "phoneme_count": len(
                    [p for p in alignment if p[2] not in OGI_NONSPEECH]
                ),
                "arpabet_phonemes": [p[2] for p in alignment],
                "language": "english",
            }
        )

    _write_json(dataset, output_file)
    print("\nOGI Spelled Speech Dataset Statistics:")
    print(f"  Total utterances: {len(dataset)}")
    print(f"  Output file: {output_file}")
    return dataset


def combine_datasets(
    processed_dir: Path,
    train_output: Optional[Path] = None,
    test_output: Optional[Path] = None,
) -> Tuple[List[Dict], List[Dict]]:
    """TIMIT train + METU + OGI -> combined train; TIMIT test -> test.

    (reference scripts/data_prep/combine_datasets.py:20-107)
    """
    processed_dir = Path(processed_dir)

    def load(name):
        path = processed_dir / name
        if not path.exists():
            print(f"  (missing: {name}, skipping)")
            return []
        with open(path) as f:
            return json.load(f)

    timit_train = load("timit_train_ipa.json")
    timit_test = load("timit_test_ipa.json")
    metu = load("metu_turkish_ipa.json")
    ogi = load("ogi_spelled_ipa.json")

    for e in timit_train:
        e["dataset_source"] = "timit"
        e["split"] = "train"
    for e in timit_test:
        e["dataset_source"] = "timit"
        e["split"] = "test"
    for e in metu:
        e["dataset_source"] = "metu_turkish"
        e["split"] = "train"
    for e in ogi:
        e["dataset_source"] = "ogi_spelled"
        e["split"] = "train"

    combined_train = timit_train + metu + ogi
    combined_test = timit_test

    _write_json(
        combined_train, train_output or processed_dir / "combined_train_ipa.json"
    )
    _write_json(
        combined_test, test_output or processed_dir / "combined_test_ipa.json"
    )
    print(
        f"Combined: {len(combined_train):,} train "
        f"(timit {len(timit_train):,} + metu {len(metu):,} + ogi {len(ogi):,}), "
        f"{len(combined_test):,} test"
    )
    return combined_train, combined_test
