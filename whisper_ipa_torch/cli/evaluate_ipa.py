"""CLI: metric self-test — golden cases + tokenization assertions.

Counterpart of ``whisper_ipa_tpu/cli/evaluate_ipa.py`` over the port's own
copy of the metrics, with the same output; host only. The reference runs
this as ``python scripts/evaluate_ipa.py`` (its inline __main__ self-test,
scripts/evaluate_ipa.py:381-462). Exits non-zero on any assertion failure.
"""

from ..metrics import (
    evaluate_batch,
    phone_error_rate,
    phone_feature_error_rate,
    phone_feature_error_rate_cosine,
    tokenize_ipa,
)

TEST_CASES = [
    ("Perfect match", "kæt", "kæt"),
    ("Small difference (aspiration)", "kæt", "kʰæt"),
    ("Vowel difference", "kæt", "kɛt"),
    ("Complete difference", "kæt", "dɑg"),
    ("Length mismatch", "kæt", "kæti"),
    ("Deletion", "kæt", "kt"),
    ("Syllabic consonant", "bʌtn̩", "bʌtn̩"),
    ("Nasalized flap vs plain", "ɾ̃æ", "ræ"),
    ("Devoiced schwa", "ə̥tʃ", "ətʃ"),
]


def main(argv=None):
    print("=" * 70)
    print("Testing PER and PFER Metrics")
    print("=" * 70)

    for name, ref, hyp in TEST_CASES:
        per = phone_error_rate(ref, hyp)
        pfer = phone_feature_error_rate(ref, hyp)
        pfer_cos = phone_feature_error_rate_cosine(ref, hyp)
        print(f"\n{name}:")
        print(f"  Reference:  {ref}")
        print(f"  Hypothesis: {hyp}")
        print(f"  PER:          {per:6.2f}%")
        print(f"  PFER-Hamming: {pfer:6.2f}%")
        print(f"  PFER-Cosine:  {pfer_cos:6.2f}%")

    refs = [tc[1] for tc in TEST_CASES]
    hyps = [tc[2] for tc in TEST_CASES]
    results = evaluate_batch(refs, hyps)
    print(f"\nBatch over {results['num_samples']} samples:")
    print(f"  Average PER:  {results['per']:.2f}% (±{results['per_std']:.2f}%)")
    print(f"  Average PFER: {results['pfer']:.2f}% (±{results['pfer_std']:.2f}%)")

    # tokenization assertions (the hard contract)
    assert tokenize_ipa("n̩æp") == ["n̩", "æ", "p"], "syllabic n broken"
    assert tokenize_ipa("ɾ̃æ") == ["ɾ̃", "æ"], "nasalized flap broken"
    assert tokenize_ipa("ə̥tʃ") == ["ə̥", "t", "ʃ"], "devoiced schwa broken"
    assert tokenize_ipa("tʃ") == ["t", "ʃ"], "affricate should split"
    assert tokenize_ipa("ŋ̍") == ["ŋ̍"], "syllabic ng broken"
    assert tokenize_ipa("kæt") == ["k", "æ", "t"], "simple phones changed"
    assert tokenize_ipa("m̩") == ["m̩"], "syllabic m broken"
    assert tokenize_ipa("l̩") == ["l̩"], "syllabic l broken"
    assert tokenize_ipa("") == [], "empty string should return empty list"
    print("\nAll tokenization assertions passed!")
    print("All tests passed!")


if __name__ == "__main__":
    main()
