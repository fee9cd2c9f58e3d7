"""CLI: evaluate a checkpoint (and optionally the base model) with PER/PFER.

Counterpart of ``whisper_ipa_tpu/cli/evaluate_model.py`` (the reference's
scripts/evaluate_model.py:271-346), with the same printed report.
Decoding is batched greedy, or beam search with ``--beam-size``; unlike
the reference, a decode error is not swallowed into empty hypotheses but
raised. ``--data-parallel`` shards each batch over the data ranks of a
torchrun world (one process a device); on one device it runs the
single-device path.

  python -m whisper_ipa_torch.cli.evaluate_model --base-model small \\
      --checkpoint run/checkpoint-1000 --test-data test.json --skip-base
  torchrun --nproc-per-node 4 -m whisper_ipa_torch.cli.evaluate_model \\
      --data-parallel ...
"""

import argparse
import os
from typing import Dict, List, Optional

import torch.distributed as dist


from ..config import get_config
from ..data.dataset import create_data_loader
from ..decode import DecodingOptions, decode
from ..metrics import evaluate_batch, phone_error_rate, phone_feature_error_rate
from ..models import load_checkpoint_auto
from ..parallel import distributed as D
from ..parallel.mesh import gather_rows, make_mesh, replicate, shard_padded_batch
from ..tokenizer import get_tokenizer
from ..train.checkpoints import check_vocab_provenance
from ..train.loop import load_or_init_params, resolve_device
from . import add_device_flag, add_overlay_flags

PAPER_TARGETS = [
    ("Best in paper (1k samples)", 21.2),
    ("Wav2Vec2Phoneme", 22.4),
    ("Human IAA", 19.6),
]


def evaluate_model(
    params,
    cfg,
    test_data_path: str,
    num_samples: Optional[int] = None,
    model_name: str = "Model",
    batch_size: int = 8,
    language: str = "en",
    data_parallel: bool = False,
    beam_size: Optional[int] = None,
) -> Dict:
    """Decode the split in batches on the parameters' device (greedy, or
    beam search of width ``beam_size``) and score it; returns
    ``evaluate_batch``'s metrics plus the "references" and "hypotheses" it
    scored.

    data_parallel: shard each decode batch over the mesh's 'data' axis
    (every rank of the world calls this; params replicated from rank 0),
    token-identical to one device; with one process it changes nothing."""
    print("=" * 70)
    print(f"Evaluating {model_name}")
    print("=" * 70)

    mesh = None
    if data_parallel:
        mesh = make_mesh()
        if mesh is not None:
            params = replicate(mesh, params)
            print(f"Data-parallel evaluation over {mesh.size} devices")

    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual,
        num_languages=cfg.num_languages,
        language=language,
    )
    dataset = create_data_loader(
        test_data_path, n_mels=cfg.n_mels, tokenizer=tokenizer
    )
    n = len(dataset) if not num_samples else min(num_samples, len(dataset))
    print(f"Evaluating on {n} samples (batch {batch_size})")

    options = DecodingOptions(
        language=language, without_timestamps=True, beam_size=beam_size
    )
    references: List[str] = []
    hypotheses: List[str] = []
    for start in range(0, n, batch_size):
        indices = list(range(start, min(start + batch_size, n)))
        batch = dataset.get_batch(indices)
        mel, n_real = shard_padded_batch(mesh, batch["mel_features"])
        results = decode(params, cfg, mel, options, tokenizer=tokenizer)
        references.extend(t.strip() for t in batch["ipa_texts"])
        hypotheses.extend(
            gather_rows(mesh, [r.text.strip() for r in results], n_real))
        for i in range(start, min(start + len(indices), 3)):
            per = phone_error_rate(references[i], hypotheses[i])
            pfer = phone_feature_error_rate(references[i], hypotheses[i])
            print(f"\nSample {i + 1}:")
            print(f"  Reference:  {references[i]}")
            print(f"  Hypothesis: {hypotheses[i]}")
            print(f"  PER:  {per:.2f}%  PFER: {pfer:.2f}%")

    results = evaluate_batch(references, hypotheses)
    print("\n" + "=" * 70)
    print(f"{model_name} - Overall Results")
    print("=" * 70)
    print(
        f"\nPER:  {results['per']:.2f}% (±{results['per_std']:.2f}%)\n"
        f"PFER: {results['pfer']:.2f}% (±{results['pfer_std']:.2f}%)\n"
        f"Samples: {results['num_samples']}"
    )
    return {**results, "references": references, "hypotheses": hypotheses}


def compare_models(base_results: Dict, trained_results: Dict) -> None:
    print("\n" + "=" * 70)
    print("Model Comparison")
    print("=" * 70)
    per_diff = base_results["per"] - trained_results["per"]
    pfer_diff = base_results["pfer"] - trained_results["pfer"]
    print(
        f"{'Metric':<30} {'Base':>10} {'Trained':>10} {'Improvement':>12}"
    )
    print(
        f"{'PER (Phone Error Rate)':<30} {base_results['per']:>9.2f}% "
        f"{trained_results['per']:>9.2f}% {per_diff:>+11.2f}%"
    )
    print(
        f"{'PFER (Feature Error Rate)':<30} {base_results['pfer']:>9.2f}% "
        f"{trained_results['pfer']:>9.2f}% {pfer_diff:>+11.2f}%"
    )
    print("\nTarget scores (zero-shot, unseen languages):")
    for name, value in PAPER_TARGETS:
        print(f"  - {name}: {value}% PFER")
    pfer = trained_results["pfer"]
    if pfer < 50:
        print("\nMINIMUM VIABLE: PFER < 50% achieved!")
    if pfer < 30:
        print("GOOD: PFER < 30% achieved!")
    if pfer < 25:
        print("EXCELLENT: PFER < 25% achieved!")
    if pfer < 21.2:
        print("SOTA: Beat paper's best zero-shot result!")


def main(argv=None) -> Dict:
    """Run the CLI; returns the trained checkpoint's results."""
    p = argparse.ArgumentParser(description="Evaluate Whisper-IPA model")
    p.add_argument(
        "--checkpoint",
        type=str,
        default="checkpoints/whisper-ipa-english/checkpoint-250",
    )
    p.add_argument(
        "--base-model", type=str, default="mlx-community/whisper-small-mlx"
    )
    p.add_argument(
        "--test-data",
        type=str,
        default="data/processed/english_only_test_ipa.json",
    )
    p.add_argument(
        "--num-samples",
        type=int,
        default=100,
        help="Number of samples (0 = all)",
    )
    p.add_argument("--skip-base", action="store_true")
    p.add_argument("--n-mels", type=int, default=None, help="(derived from model)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument(
        "--beam-size", type=int, default=None,
        help="beam-search decoding width (default: greedy)",
    )
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch over the data ranks of a "
                   "torchrun world (one process a device)")
    add_overlay_flags(p)
    add_device_flag(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.data_parallel and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not dist.is_initialized():
            D.initialize(device=device)  # torchrun: one process a device
        device = D.default_device()
    num_samples = None if args.num_samples == 0 else args.num_samples
    cfg = get_config(args.base_model)
    base_params = load_or_init_params(args.base_model, cfg, args.weights,
                                      device=device)

    base_results = None
    if not args.skip_base:
        base_results = evaluate_model(
            base_params, cfg, args.test_data, num_samples,
            model_name="Base Whisper Model", batch_size=args.batch_size,
            data_parallel=args.data_parallel, beam_size=args.beam_size,
        )

    if os.path.isdir(args.checkpoint):
        check_vocab_provenance(
            args.checkpoint,
            get_tokenizer(multilingual=cfg.multilingual),
            strict=True,
        )
    trained_params, n_loaded = load_checkpoint_auto(
        args.checkpoint, base_params, args.full_ckpt
    )
    print(f"Loaded {n_loaded} tensors from {args.checkpoint}")
    trained_results = evaluate_model(
        trained_params, cfg, args.test_data, num_samples,
        model_name="Trained Checkpoint", batch_size=args.batch_size,
        data_parallel=args.data_parallel, beam_size=args.beam_size,
    )

    if base_results:
        compare_models(base_results, trained_results)
    print("\nEvaluation Complete!")
    return trained_results


if __name__ == "__main__":
    main()
