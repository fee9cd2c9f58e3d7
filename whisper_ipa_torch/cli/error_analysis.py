"""CLI: phone-confusion error analysis of a model on a test set.

Counterpart of ``whisper_ipa_tpu/cli/error_analysis.py``, on ``--device``:
transcribes a dataset (or reads a saved predictions JSON) and reports top
phone substitutions/insertions/deletions and PER/PFER distributions.

  python -m whisper_ipa_torch.cli.error_analysis --checkpoint ... \\
      --test-data data/processed/combined_test_ipa.json
  python -m whisper_ipa_torch.cli.error_analysis --predictions preds.json

Returns the report (``confusion_analysis``'s dict) to a caller of
``main(argv)``.
"""

import argparse
import json

from ..metrics.analysis import confusion_analysis, print_confusion_report
from . import add_device_flag, add_overlay_flags


def main(argv=None):
    p = argparse.ArgumentParser(description="Phone-confusion error analysis")
    p.add_argument(
        "--predictions",
        default=None,
        help='JSON list of {"reference", "hypothesis"} pairs',
    )
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--base-model", default="mlx-community/whisper-small-mlx")
    p.add_argument("--weights", default=None)
    p.add_argument("--test-data", default=None)
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--output", default=None, help="Write full report JSON")
    add_overlay_flags(p)
    add_device_flag(p)
    args = p.parse_args(argv)

    if args.predictions:
        with open(args.predictions, encoding="utf-8") as f:
            pairs = json.load(f)
        refs = [e["reference"] for e in pairs]
        hyps = [e["hypothesis"] for e in pairs]
    else:
        if not args.test_data:
            p.error("--test-data or --predictions required")
        from ..config import get_config
        from ..data.dataset import create_data_loader
        from ..decode import DecodingOptions, decode
        from ..models import load_checkpoint_auto
        from ..tokenizer import get_tokenizer
        from ..train.loop import load_or_init_params, resolve_device

        device = resolve_device(args.device)
        cfg = get_config(args.base_model)
        params = load_or_init_params(args.base_model, cfg, args.weights,
                                     device=device)
        if args.checkpoint:
            params, n = load_checkpoint_auto(
                args.checkpoint, params, args.full_ckpt
            )
            print(f"Loaded {n} tensors")
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual, num_languages=cfg.num_languages
        )
        dataset = create_data_loader(
            args.test_data, n_mels=cfg.n_mels, tokenizer=tokenizer
        )
        n = min(args.num_samples or len(dataset), len(dataset))
        options = DecodingOptions(language="en", without_timestamps=True)
        refs, hyps = [], []
        for start in range(0, n, args.batch_size):
            idx = list(range(start, min(start + args.batch_size, n)))
            batch = dataset.get_batch(idx)
            results = decode(
                params,
                cfg,
                batch["mel_features"],
                options,
                tokenizer=tokenizer,
            )
            refs.extend(t.strip() for t in batch["ipa_texts"])
            hyps.extend(r.text.strip() for r in results)

    report = confusion_analysis(refs, hyps)
    print_confusion_report(report)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(report, f, ensure_ascii=False, indent=2)
        print(f"\nFull report written to {args.output}")
    return report


if __name__ == "__main__":
    main()
