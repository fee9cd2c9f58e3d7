"""CLI: zero-shot IPA evaluation on the multipa test set.

Streams the zeroshot_test.json entries (gold annotator transcriptions of
Luganda / Upper Sorbian / Hakha Chin / Tatar utterances) through batched
inference and scores PER / PFER against the paper targets — the
whisper-large-v3 multilingual zero-shot configuration (BASELINE.json
config 5; data layout from reference scripts/parse_zeroshot_test.py).
Counterpart of ``whisper_ipa_tpu/cli/evaluate_zeroshot.py``, on one
device: each utterance's log-mel is computed where the model runs (K1 on
CUDA), and the decode detects the language per row unless ``--language``
is given. Returns ``evaluate_batch``'s metrics plus the "references" and
"hypotheses" it scored.

  python -m whisper_ipa_torch.cli.evaluate_zeroshot --base-model tiny \\
      --checkpoint run/checkpoint-600 --test-data zeroshot_test.json
"""

import argparse
import json
from typing import List

import torch

from ..audio import load_audio, pad_or_trim
from ..config import get_config
from ..decode import DecodingOptions, decode
from ..metrics import evaluate_batch, normalize_ipa_for_comparison
from ..models import load_checkpoint_auto
from ..ops import log_mel_spectrogram
from ..tokenizer import get_tokenizer
from ..train.loop import load_or_init_params, resolve_device
from . import add_device_flag, add_overlay_flags

PAPER_TARGETS = [
    ("multipa Ours (1k)", 21.2),
    ("Wav2Vec2Phoneme", 22.4),
    ("Allosaurus", 34.2),
    ("Human IAA (floor)", 19.6),
]


def main(argv=None):
    p = argparse.ArgumentParser(description="Zero-shot IPA evaluation")
    p.add_argument(
        "--test-data", default="data/processed/zeroshot_test.json"
    )
    p.add_argument("--checkpoint", default=None)
    p.add_argument(
        "--base-model", default="mlx-community/whisper-large-v3-mlx"
    )
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=0, help="0 = all")
    p.add_argument(
        "--language",
        default=None,
        help="Force a language token (default: auto-detect per utterance)",
    )
    add_overlay_flags(p)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.test_data, encoding="utf-8") as f:
        data = json.load(f)
    entries = [
        e
        for e in data
        if e.get("gold_ipa") and e.get("audio_path")
    ]
    if args.num_samples:
        entries = entries[: args.num_samples]
    print(f"Zero-shot entries with gold IPA + audio: {len(entries)}")

    cfg = get_config(args.base_model)
    params = load_or_init_params(args.base_model, cfg, args.weights,
                                 device=device)
    if args.checkpoint:
        params, n_loaded = load_checkpoint_auto(
            args.checkpoint, params, args.full_ckpt
        )
        print(f"Loaded {n_loaded} tensors from {args.checkpoint}")

    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual,
        num_languages=cfg.num_languages,
        language=args.language or "en",
    )
    options = DecodingOptions(
        language=args.language, without_timestamps=True
    )

    references: List[str] = []
    hypotheses: List[str] = []
    for start in range(0, len(entries), args.batch_size):
        chunk = entries[start : start + args.batch_size]
        mels = []
        for e in chunk:
            audio = pad_or_trim(load_audio(e["audio_path"]))
            with torch.inference_mode():
                mels.append(log_mel_spectrogram(
                    torch.from_numpy(audio).to(device), n_mels=cfg.n_mels))
        results = decode(
            params, cfg, torch.stack(mels), options, tokenizer=tokenizer
        )
        for e, r in zip(chunk, results):
            references.append(normalize_ipa_for_comparison(e["gold_ipa"]))
            hypotheses.append(normalize_ipa_for_comparison(r.text.strip()))
        print(f"  {min(start + args.batch_size, len(entries))}/{len(entries)}")

    results = evaluate_batch(references, hypotheses)
    print("\n" + "=" * 70)
    print("Zero-shot results")
    print("=" * 70)
    print(f"PER:  {results['per']:.2f}% (±{results['per_std']:.2f}%)")
    print(f"PFER: {results['pfer']:.2f}% (±{results['pfer_std']:.2f}%)")
    print("\nPaper comparison (PFER):")
    for name, target in PAPER_TARGETS:
        delta = results["pfer"] - target
        print(f"  {name:<24} {target:>5.1f}%   (ours {delta:+.1f}%)")
    if results["pfer"] < 21.2:
        print("\nSOTA: beat the paper's best zero-shot result!")
    return {**results, "references": references, "hypotheses": hypotheses}


if __name__ == "__main__":
    main()
