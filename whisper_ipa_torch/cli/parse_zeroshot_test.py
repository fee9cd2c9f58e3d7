"""CLI: assemble the zero-shot test JSON from annotator sheets.

(reference scripts/parse_zeroshot_test.py)
"""

import argparse

from ..data.prep.zeroshot import build_zeroshot_json


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Parse zero-shot test annotations into zeroshot_test.json"
    )
    p.add_argument("--ariga-xlsx", default="test/IPA_annotation_sheet_Ariga.xlsx")
    p.add_argument(
        "--hamanishi-xlsx", default="test/IPA_annotation_sheet_Hamanishi.xlsx"
    )
    p.add_argument(
        "--test-data-csv", default="references/multipa/test_data.csv"
    )
    p.add_argument("--wav-dir", default="test/test")
    p.add_argument("--output", default="data/processed/zeroshot_test.json")
    args = p.parse_args(argv)

    return build_zeroshot_json(
        args.ariga_xlsx,
        args.hamanishi_xlsx,
        args.test_data_csv,
        args.wav_dir,
        args.output,
    )


if __name__ == "__main__":
    main()
