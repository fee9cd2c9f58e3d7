"""CLI: corpus preparation (TIMIT / METU / OGI / CommonVoice / combine / verify).

One subcommand per reference script:
  timit        (scripts/data_prep/prepare_timit_dataset.py)
  metu         (scripts/data_prep/prepare_metu_turkish.py)
  ogi          (scripts/data_prep/prepare_ogi_spelled.py)
  commonvoice  (scripts/data_prep/prepare_commonvoice_dataset.py)
  g2p          (create_dataset_scripts/preprocess_local.py + create_all_datasets.py)
  combine      (scripts/data_prep/combine_datasets.py)
  verify       (scripts/data_prep/verify_ipa_normalization.py)
  analyze      (create_dataset_scripts/analyze_dataset.py)
"""

import argparse
from pathlib import Path

from ..data.prep import (
    analyze_dataset,
    analyze_language,
    apply_normalization,
    combine_datasets,
    create_datasets,
    prepare_commonvoice,
    prepare_metu,
    prepare_ogi,
    prepare_timit,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("timit")
    sp.add_argument("--timit-root", required=True)
    sp.add_argument("--output-dir", default="data/processed")
    sp.add_argument("--splits", nargs="+", default=["TRAIN", "TEST"])

    sp = sub.add_parser("metu")
    sp.add_argument("--metu-root", required=True)
    sp.add_argument("--output", default="data/processed/metu_turkish_ipa.json")

    sp = sub.add_parser("ogi")
    sp.add_argument("--ogi-root", required=True)
    sp.add_argument("--output", default="data/processed/ogi_spelled_ipa.json")

    sp = sub.add_parser("commonvoice")
    sp.add_argument("--input-dir", required=True)
    sp.add_argument("--audio-root", required=True)
    sp.add_argument("--output-dir", default="data/processed")
    sp.add_argument(
        "--languages", nargs="+",
        default=["ja", "pl", "mt", "hu", "fi", "el", "ta"],
    )
    sp.add_argument("--train-per-lang", nargs="+", type=int, default=[1000, 2000])
    sp.add_argument("--val-per-lang", type=int, default=200)
    sp.add_argument("--test-per-lang", type=int, default=100)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--no-check-audio", action="store_true")

    sp = sub.add_parser("g2p")
    sp.add_argument("--dataset-root", required=True)
    sp.add_argument("--output-dir", default="data/processed")
    sp.add_argument(
        "--languages", nargs="+",
        default=["ja", "pl", "mt", "hu", "fi", "el", "ta"],
    )
    sp.add_argument("--mode", default="improved",
                    choices=["raw", "filtered", "improved"])
    sp.add_argument("--train-n", type=int, default=1000)
    sp.add_argument("--val-n", type=int, default=200)
    sp.add_argument("--test-n", type=int, default=100)
    sp.add_argument("--seed", type=int, default=42)

    sp = sub.add_parser(
        "g2p-all",
        help="all three quality versions (v1_raw/v2_filtered/v3_improved), "
        "reference create_all_datasets script",
    )
    sp.add_argument("--dataset-root", required=True)
    sp.add_argument("--output-root", default="data")
    sp.add_argument(
        "--languages", nargs="+",
        default=["ja", "pl", "mt", "hu", "fi", "el", "ta"],
    )
    sp.add_argument("--train-n", type=int, default=1000)
    sp.add_argument("--val-n", type=int, default=200)
    sp.add_argument("--test-n", type=int, default=100)
    sp.add_argument("--seed", type=int, default=42)

    sp = sub.add_parser("combine")
    sp.add_argument("--processed-dir", default="data/processed")

    sp = sub.add_parser("verify")
    sp.add_argument("dataset", nargs="+")
    sp.add_argument("--fix", action="store_true")

    sp = sub.add_parser("analyze")
    sp.add_argument("--dataset-root", required=True)
    sp.add_argument("--languages", nargs="+", required=True)

    args = p.parse_args(argv)

    if args.cmd == "timit":
        out = Path(args.output_dir)
        for split in args.splits:
            prepare_timit(
                Path(args.timit_root),
                out / f"timit_{split.lower()}_ipa.json",
                split=split,
            )
    elif args.cmd == "metu":
        prepare_metu(Path(args.metu_root), Path(args.output))
    elif args.cmd == "ogi":
        prepare_ogi(Path(args.ogi_root), Path(args.output))
    elif args.cmd == "commonvoice":
        prepare_commonvoice(
            Path(args.input_dir),
            Path(args.audio_root),
            Path(args.output_dir),
            languages=args.languages,
            train_per_lang=args.train_per_lang,
            val_per_lang=args.val_per_lang,
            test_per_lang=args.test_per_lang,
            seed=args.seed,
            check_audio=not args.no_check_audio,
        )
    elif args.cmd == "g2p":
        create_datasets(
            Path(args.dataset_root),
            Path(args.output_dir),
            languages=args.languages,
            mode=args.mode,
            train_n=args.train_n,
            val_n=args.val_n,
            test_n=args.test_n,
            seed=args.seed,
        )
    elif args.cmd == "g2p-all":
        versions = {
            "v1_raw": "raw",
            "v2_filtered": "filtered",
            "v3_improved": "improved",
        }
        summary = {}
        for dirname, mode in versions.items():
            print(f"\n=== {dirname} (mode={mode}) ===")
            summary[dirname] = create_datasets(
                Path(args.dataset_root),
                Path(args.output_root) / dirname,
                languages=args.languages,
                mode=mode,
                train_n=args.train_n,
                val_n=args.val_n,
                test_n=args.test_n,
                seed=args.seed,
            )
        print("\nSummary:")
        for dirname, counts in summary.items():
            print(f"  {dirname}: {counts}")
    elif args.cmd == "combine":
        combine_datasets(Path(args.processed_dir))
    elif args.cmd == "verify":
        for ds in args.dataset:
            needs, _ = analyze_dataset(Path(ds))
            if needs and args.fix:
                apply_normalization(Path(ds))
    elif args.cmd == "analyze":
        for lang in args.languages:
            analyze_language(lang, Path(args.dataset_root))


if __name__ == "__main__":
    main()
