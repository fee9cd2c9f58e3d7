"""Derive a Japanese kanji-reading table from (sentence, IPA) corpus pairs.

The reference delegated Japanese G2P to an external converter backed by a
morphological analyzer; neither is available offline. What IS on disk is
the converter's OUTPUT: ~1300 CommonVoice ja sentences paired with their
IPA (reference data/v2_filtered/ja_*_ipa.json). Since our kana->IPA
converter reproduces the corpus conventions (measured: >60% exact on
kana-only sentences, the rest morphology-boundary effects), the kanji
readings can be recovered by ALIGNMENT:

1. convert a sentence with unknown-kanji runs replaced by sentinels,
2. match the known kana segments' IPA inside the reference IPA,
3. the IPA between matches belongs to the kanji run — invert it back to
   hiragana with a reverse syllable table,
4. keep a candidate only if re-converting the full sentence with it
   reproduces the reference IPA exactly (self-validation), and iterate:
   each round's accepted readings shrink the unknown runs of harder
   sentences.

The result ships as ``ja_readings_corpus.tsv`` (word<TAB>kana), loaded by
japanese.py alongside the built-in table. This is derived DATA (readings
of words, recoverable from any dictionary), not reference code.

Usage:
    python -m whisper_ipa_torch.data.prep.g2p.derive_ja_readings \
        --data-json ja_train.json [ja_val.json ...] --out readings.tsv
"""

from __future__ import annotations

import argparse
import json
import re
import unicodedata
from typing import Dict, List, Optional, Tuple

from . import japanese as jm

_SENTINEL = ""

# reverse syllable table: corpus-convention IPA -> hiragana, longest
# match first. Built from the forward tables so it stays in sync.
def _reverse_table() -> List[Tuple[str, str]]:
    rev: Dict[str, str] = {}

    def conv(ipa: str) -> str:
        return (
            ipa.replace("a", "ä").replace("o", "o̞").replace("e", "e̞")
        )

    for kana, ipa in jm._BASE.items():
        if kana in ("ゐ", "ゑ", "ぁ", "ぃ", "ぅ", "ぇ", "ぉ"):
            continue  # prefer the canonical kana for these sounds
        rev.setdefault(conv(ipa), kana)
    for kana, onset in jm._DIGRAPH_ONSET.items():
        for small, v in jm._SMALL_VOWEL.items():
            rev.setdefault(conv(onset + v), kana + small)
    for kana, onset in jm._FOREIGN_ONSET.items():
        for small, v in jm._SMALL_VOWEL_FULL.items():
            rev.setdefault(conv(onset + v), kana + small)
    # nasal variants (place assimilation happens after the fact)
    for n in ("ɴ", "ŋ", "n'"):
        rev.setdefault(n, "ん")
    rev.setdefault("n", "ん")
    rev.setdefault("m", "ん")
    # を is always the particle; ん handled above
    items = sorted(rev.items(), key=lambda kv: -len(kv[0]))
    return items


_REV: Optional[List[Tuple[str, str]]] = None


def ipa_to_kana(ipa: str) -> Optional[str]:
    """Invert corpus-convention IPA to hiragana; None if not invertible.

    Handles length marks (vowel ː -> repeat/ー, consonant ː -> っ) and
    geminate nasals. The inversion only needs to be good enough that
    re-CONVERTING the kana reproduces the exact source IPA — the caller
    validates that, so lossy corners just drop candidates.
    """
    global _REV
    if _REV is None:
        _REV = _reverse_table()
    out: List[str] = []
    i = 0
    n = len(ipa)
    while i < n:
        # vowel length: previous kana's vowel lengthens
        if ipa[i] == "ː":
            if not out:
                return None
            out.append("ー")  # chōonpu lengthens any vowel on re-conversion
            i += 1
            continue
        matched = False
        for seg, kana in _REV:
            if ipa.startswith(seg, i):
                # consonant gemination: onset + ː + vowel -> っ + syllable
                j = i + len(seg)
                out.append(kana)
                i = j
                matched = True
                break
        if not matched:
            # geminate: Cː... -> っ + re-parse from the consonant
            m = re.match(r"([^äieoɯ̞ːˈ]+)ː", ipa[i:])
            if m:
                rest = ipa[i : i + len(m.group(1))] + ipa[i + len(m.group(0)) :]
                sub = ipa_to_kana(rest)
                if sub is None:
                    return None
                out.append("っ")
                out.append(sub)
                return "".join(out)
            return None
    return "".join(out)


def _norm(s: str) -> str:
    return (
        unicodedata.normalize("NFC", s)
        .replace("͡", "")  # tie bar
        .replace(" ", "")
        .replace("g", "ɡ")
    )


def _segments(sent: str) -> List[Tuple[bool, str]]:
    """Split into (is_kanji_run, text) after known-word substitution."""
    text = jm.kanji_to_kana(unicodedata.normalize("NFC", sent))
    segs: List[Tuple[bool, str]] = []
    cur: List[str] = []
    cur_kanji = False
    for ch in text:
        is_k = 0x4E00 <= ord(ch) <= 0x9FFF
        if cur and is_k != cur_kanji:
            segs.append((cur_kanji, "".join(cur)))
            cur = []
        cur.append(ch)
        cur_kanji = is_k
    if cur:
        segs.append((cur_kanji, "".join(cur)))
    return segs


def _try_derive(sent: str, ref_ipa: str) -> List[Tuple[str, str]]:
    """Extract (kanji_run, kana_reading) candidates from one pair."""
    segs = _segments(jm.remove_ja_punct(sent))
    runs = [t for k, t in segs if k]
    if not runs:
        return []
    # convert with sentinels standing in for the kanji runs
    marked = "".join(_SENTINEL if k else t for k, t in segs)
    try:
        # sentinel chars pass through the converter untouched (they're
        # skipped by the syllable loop) — convert each kana span alone
        # instead, keeping particle marking from full-sentence context
        kana_ipa: List[str] = []
        h = jm._mark_particles(jm._to_hiragana(marked))
        for span in h.split(_SENTINEL):
            kana_ipa.append(_norm(jm.kana_to_ipa(span)) if span else "")
    except ValueError:
        return []
    ref = _norm(ref_ipa)
    # walk the reference IPA matching the known spans in order
    out: List[Tuple[str, str]] = []
    pos = 0
    # leading kana span must be a prefix
    if kana_ipa[0]:
        if not ref.startswith(kana_ipa[0]):
            return []
        pos = len(kana_ipa[0])
    for idx, run in enumerate(runs):
        nxt = kana_ipa[idx + 1]
        if idx == len(runs) - 1:
            # last: next span must be a suffix
            if nxt and not ref.endswith(nxt):
                return []
            end = len(ref) - len(nxt)
        else:
            if not nxt:
                return []  # adjacent runs: ambiguous split
            end = ref.find(nxt, pos + 1)
            if end < 0:
                return []
        seg_ipa = ref[pos:end]
        if not seg_ipa:
            return []
        kana = ipa_to_kana(seg_ipa)
        if kana:
            out.append((run, kana, seg_ipa))
        pos = end + len(nxt)
    return out


def derive(entries: List[dict], rounds: int = 5, verbose: bool = True):
    """Iteratively derive readings; returns (accepted dict, report)."""
    accepted: Dict[str, str] = {}
    for rnd in range(rounds):
        candidates: Dict[str, Dict[str, tuple]] = {}
        for e in entries:
            for run, kana, seg in _try_derive(
                e["sentence"], e["ipa_transcription"]
            ):
                if run in jm.KANJI_READINGS or run in accepted:
                    continue
                cnt, _ = candidates.setdefault(run, {}).get(kana, (0, seg))
                candidates[run][kana] = (cnt + 1, seg)
        new = 0
        for run, votes in candidates.items():
            kana, (cnt, seg) = max(votes.items(), key=lambda kv: kv[1][0])
            # self-validation, either of:
            # (a) the kana round-trips in isolation to the extracted
            #     IPA segment (the extraction already anchored that
            #     segment between exact matches of the surrounding
            #     spans), or
            # (b) re-converting a full source sentence reproduces its
            #     reference IPA exactly (catches boundary-assimilated
            #     extractions whose isolated conversion differs).
            try:
                local_ok = _norm(jm.kana_to_ipa(kana)) == seg
            except ValueError:
                local_ok = False
            jm.KANJI_READINGS[run] = kana
            ok = local_ok
            if not ok:
                for e in entries:
                    if run not in e["sentence"]:
                        continue
                    try:
                        mine = _norm(
                            jm.kana_to_ipa(jm.remove_ja_punct(e["sentence"]))
                        )
                    except ValueError:
                        continue
                    if mine == _norm(e["ipa_transcription"]):
                        ok = True
                        break
            if ok:
                accepted[run] = kana
                new += 1
            else:
                del jm.KANJI_READINGS[run]
        if verbose:
            print(f"round {rnd}: +{new} readings (total {len(accepted)})")
        if new == 0:
            break
    return accepted


def coverage(entries: List[dict]) -> Tuple[int, int, int]:
    """(total, covered, exact-match) under the current reading table."""
    total = covered = exact = 0
    for e in entries:
        total += 1
        try:
            mine = jm.kana_to_ipa(jm.remove_ja_punct(e["sentence"]))
        except ValueError:
            continue
        if not mine.strip():
            continue  # non-Japanese junk rows
        covered += 1
        if _norm(mine) == _norm(e["ipa_transcription"]):
            exact += 1
    return total, covered, exact


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-json", nargs="+", required=True)
    ap.add_argument("--out", required=True, help="output TSV (word\\tkana)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    entries: List[dict] = []
    for p in args.data_json:
        with open(p) as f:
            entries.extend(json.load(f))
    entries = [e for e in entries if "sentence" in e and "ipa_transcription" in e]

    t0, c0, e0 = coverage(entries)
    print(f"before: covered {c0}/{t0} ({100*c0/t0:.1f}%), exact {e0}")
    accepted = derive(entries, rounds=args.rounds)
    t1, c1, e1 = coverage(entries)
    print(f"after:  covered {c1}/{t1} ({100*c1/t1:.1f}%), exact {e1}")

    with open(args.out, "w", encoding="utf-8") as f:
        f.write("# derived by derive_ja_readings.py: kanji word -> kana\n")
        for run in sorted(accepted):
            f.write(f"{run}\t{accepted[run]}\n")
    print(f"wrote {len(accepted)} readings to {args.out}")


if __name__ == "__main__":
    main()
