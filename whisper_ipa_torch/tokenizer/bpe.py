"""Byte-pair encoding core: GPT-2 byte mapping + rank-based BPE merge.

Implements the byte-level BPE used by the Whisper/GPT-2 tokenizer family.
Ranks map token *bytes* to integer ids (the tiktoken ``.tiktoken`` file
format: one ``base64(token_bytes) rank`` pair per line).

When the real Whisper rank file (``multilingual.tiktoken``) is present we
produce bit-identical token ids; without it callers can fall back to a pure
byte-level vocabulary (see vocab.py) that preserves the special-token layout.

Behavioral reference: the upstream pipeline tokenizes IPA through the stock
multilingual Whisper tokenizer (reference scripts/ipa_data_loader.py:102-131).
"""

from __future__ import annotations

import base64
from functools import lru_cache
from typing import Dict, Iterable, List

import regex as _regex

# GPT-2 pre-tokenization pattern (shared by the Whisper tokenizer).
GPT2_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache(maxsize=4)
def _compiled_pat(pat: str):
    return _regex.compile(pat)


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Load a tiktoken-format rank file: ``base64(token) rank`` per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def byte_level_ranks(n_base: int = 50257) -> Dict[bytes, int]:
    """Degenerate rank table: 256 single-byte tokens, no merges.

    Token id i == byte value i for i < 256; ids 256..n_base-1 are unused
    placeholders so the special-token id layout matches the real vocabulary.
    Every Unicode string round-trips (multi-byte characters become several
    tokens). Used when no Whisper rank file is available on disk.
    """
    del n_base  # layout handled by the tokenizer; only byte tokens exist
    return {bytes([i]): i for i in range(256)}


class BPE:
    """Rank-driven byte-pair encoder/decoder."""

    def __init__(self, ranks: Dict[bytes, int], pat: str = GPT2_PAT):
        self.ranks = ranks
        self.pat = _compiled_pat(pat)
        self.decoder: Dict[int, bytes] = {v: k for k, v in ranks.items()}
        self._cache: Dict[bytes, List[int]] = {}

    @property
    def n_vocab(self) -> int:
        return max(self.ranks.values()) + 1 if self.ranks else 0

    def _bpe_merge(self, piece: bytes) -> List[int]:
        """Merge a pre-tokenized piece into ids using the rank table."""
        if piece in self.ranks:
            return [self.ranks[piece]]
        cached = self._cache.get(piece)
        if cached is not None:
            return cached

        parts: List[bytes] = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_rank is None:
                break
            parts = (
                parts[:best_i]
                + [parts[best_i] + parts[best_i + 1]]
                + parts[best_i + 2 :]
            )

        out: List[int] = []
        for part in parts:
            rank = self.ranks.get(part)
            if rank is not None:
                out.append(rank)
            else:
                # No merge path and no single token: emit per-byte ids.
                out.extend(self.ranks[part[i : i + 1]] for i in range(len(part)))
        if len(piece) < 64:
            self._cache[piece] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self.pat.findall(text):
            ids.extend(self._bpe_merge(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.decoder.get(i, b"") for i in ids)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")
