"""Longest-match grapheme-to-IPA rule engine.

A single linear scanner replaces the reference's cascade of per-language
ad-hoc ``str.replace`` passes (reference converters_improved/*,
multipa converters): rules are (grapheme, ipa) pairs; at each position the
longest matching grapheme wins. Context-dependent rules are supported via
optional pre/post regex passes.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

Rule = Tuple[str, str]


class RuleG2P:
    """Longest-match table converter with optional regex pre/post passes."""

    def __init__(
        self,
        rules: Iterable[Rule],
        pre: Optional[List[Tuple[str, str]]] = None,
        post: Optional[List[Tuple[str, str]]] = None,
        lowercase: bool = True,
        keep_unknown: bool = False,
    ):
        self.table: Dict[str, str] = dict(rules)
        self.max_len = max((len(k) for k in self.table), default=1)
        self.pre = [(re.compile(p), r) for p, r in (pre or [])]
        self.post = [(re.compile(p), r) for p, r in (post or [])]
        self.lowercase = lowercase
        self.keep_unknown = keep_unknown

    def strip_punct(self, text: str) -> str:
        """Keep word characters and whitespace (reference convention)."""
        return "".join(re.findall(r"[\s\w]", text, re.MULTILINE))

    def __call__(self, text: str) -> str:
        text = unicodedata.normalize("NFC", text)
        if self.lowercase:
            text = text.lower()
        text = self.strip_punct(text)
        for pat, repl in self.pre:
            text = pat.sub(repl, text)

        out: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for ln in range(min(self.max_len, n - i), 0, -1):
                piece = text[i : i + ln]
                if piece in self.table:
                    out.append(self.table[piece])
                    i += ln
                    matched = True
                    break
            if not matched:
                ch = text[i]
                if ch.isspace() or self.keep_unknown:
                    out.append(ch)
                i += 1
        result = "".join(out)
        for pat, repl in self.post:
            result = pat.sub(repl, result)
        return result


def geminate(rules: Iterable[Rule]) -> List[Rule]:
    """Add doubled-consonant -> long-consonant rules (cc -> Cː)."""
    out = list(rules)
    for k, v in list(out):
        if len(k) == 1 and k.isalpha() and v and "ː" not in v:
            out.append((k + k, v + "ː"))
    return out


def from_mapping_csv(path: str, **kwargs) -> "RuleG2P":
    """Build a converter from an Epitran-style mapping CSV (Orth,Phon).

    Lets users plug in any of Epitran's published map files (the dependency
    the reference used for hu/pl) without the package itself.
    """
    import csv

    rules = []
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header and header[0].strip().lower() not in ("orth", "grapheme"):
            # no header: treat the first row as data
            if len(header) >= 2:
                rules.append((header[0], header[1]))
        for row in reader:
            if len(row) >= 2 and row[0]:
                rules.append((row[0], row[1]))
    return RuleG2P(rules, **kwargs)
