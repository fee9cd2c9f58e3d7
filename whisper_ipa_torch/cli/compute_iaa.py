"""CLI: inter-annotator agreement on the zero-shot test set.

(reference scripts/compute_iaa.py — reproduces the paper's 19.6% PFER as
the metric-validation oracle.)
"""

import argparse

from ..data.prep.zeroshot import compute_iaa


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute inter-annotator agreement")
    p.add_argument(
        "--input",
        type=str,
        default="data/processed/zeroshot_test.json",
        help="zeroshot_test.json produced by parse_zeroshot_test",
    )
    args = p.parse_args(argv)

    out = compute_iaa(args.input)
    a = out["ariga_ref"]
    b = out["hamanishi_ref"]
    print("\n--- Ariga as reference ---")
    print(f"  PER:          {a['per']:.1f}% (±{a['per_std']:.1f}%)")
    print(f"  PFER-Hamming: {a['pfer_hamming']:.1f}% (±{a['pfer_hamming_std']:.1f}%)")
    print(f"  PFER-Cosine:  {a['pfer_cosine']:.1f}% (±{a['pfer_cosine_std']:.1f}%)")
    print("\n--- Hamanishi as reference ---")
    print(f"  PER:          {b['per']:.1f}% (±{b['per_std']:.1f}%)")
    print(f"  PFER-Hamming: {b['pfer_hamming']:.1f}% (±{b['pfer_hamming_std']:.1f}%)")
    print(f"  PFER-Cosine:  {b['pfer_cosine']:.1f}% (±{b['pfer_cosine_std']:.1f}%)")
    name, value = out["best"]
    print(f"\nBest match to paper {out['paper_iaa']}%: {name} = {value:.1f}%")
    return out


if __name__ == "__main__":
    main()
