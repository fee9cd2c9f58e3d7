"""Shared helpers for chunked training (C optimizer steps per call).

Counterpart of ``whisper_ipa_tpu/train/chunking.py``. Used by
``train/loop.py``, ``cli/train_medusa.py`` and ``cli/distill_draft.py``
so the chunk-sizing and batch-stacking rules stay in one place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1): chunk lengths are powers of
    two, as in the reference, so a run meets O(log C) chunk shapes."""
    n = max(1, n)
    while n & (n - 1):
        n &= n - 1
    return n


def stack_pad_batches(
    batches: Sequence[Dict],
    eot: int,
    bf16_mels: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack C loader batches into (C, B, ...) mel and token tensors on
    the host.

    Bucketed token widths may differ across the chunk; they are
    right-padded with EOT to the chunk's widest (loss-exact: the loss mask
    keeps only the first EOT, and the pad positions are causal-masked).
    ``bf16_mels`` casts the mel stack to bfloat16 (round to nearest even,
    the bits of the reference's ``ml_dtypes`` cast), which halves the
    upload; both consumers cast their input at entry under bf16 compute,
    so the result does not change.
    """
    tw = max(b["tokens"].shape[1] for b in batches)
    toks: List[np.ndarray] = []
    for b in batches:
        t = np.asarray(b["tokens"])
        if t.shape[1] < tw:
            pad = np.full((t.shape[0], tw - t.shape[1]), eot, dtype=t.dtype)
            t = np.concatenate([t, pad], axis=1)
        toks.append(t)
    mels = torch.from_numpy(
        np.stack([np.asarray(b["mel_features"]) for b in batches]))
    if bf16_mels:
        mels = mels.to(torch.bfloat16)
    return mels, torch.from_numpy(np.stack(toks))
