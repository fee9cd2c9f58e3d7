"""CLI: verify IPA coverage of the tokenizer vocabulary.

Encodes a battery of IPA characters (incl. combining diacritics and
Mandarin tone letters) through the tokenizer, checks round-trips, and flags
characters needing multiple tokens (reference
scripts/experimental/check_vocab.py).
"""

import argparse

IPA_BATTERY = (
    # pulmonic consonants
    "p b t d ʈ ɖ c ɟ k ɡ q ɢ ʔ m ɱ n ɳ ɲ ŋ ɴ ʙ r ʀ ɾ ɽ "
    "ɸ β f v θ ð s z ʃ ʒ ʂ ʐ ç ʝ x ɣ χ ʁ ħ ʕ h ɦ ɬ ɮ ʋ ɹ ɻ j ɰ "
    "l ɭ ʎ ʟ ɫ w ɥ ʍ ɕ ʑ "
    # vowels
    "i y ɨ ʉ ɯ u ɪ ʏ ʊ e ø ɘ ɵ ɤ o ə ɛ œ ɜ ɞ ʌ ɔ æ ɐ a ɶ ɑ ɒ ɚ ɝ "
    # diacritics on bases
    "n̩ m̩ l̩ ŋ̍ ə̥ ɾ̃ kʰ dʱ tʷ tʲ ã aː "
    # tone letters
    "˥ ˦ ˧ ˨ ˩ ˨˩˦"
).split()


def check_tokens(tokenizer, chars):
    multi = []
    failed = []
    for ch in chars:
        ids = tokenizer.encode(ch)
        back = tokenizer.decode_text(ids)
        if back != ch:
            failed.append((ch, ids, back))
        elif len(ids) > 1:
            multi.append((ch, len(ids)))
    return multi, failed


def main(argv=None):
    p = argparse.ArgumentParser(description="Tokenizer IPA coverage check")
    p.add_argument("--multilingual", action="store_true", default=True)
    p.add_argument("--extra", nargs="*", default=[], help="Extra strings")
    args = p.parse_args(argv)

    from ..tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=args.multilingual)
    chars = IPA_BATTERY + list(args.extra)
    multi, failed = check_tokens(tok, chars)

    print(f"Checked {len(chars)} IPA strings")
    print(f"Round-trip failures: {len(failed)}")
    for ch, ids, back in failed:
        print(f"  {ch!r} -> {ids} -> {back!r}")
    print(f"Multi-token characters: {len(multi)}")
    for ch, n in multi[:20]:
        print(f"  {ch!r}: {n} tokens")
    if failed:
        raise SystemExit(1)
    print("All IPA strings round-trip through the tokenizer.")
    return 0


if __name__ == "__main__":
    main()
