"""Phone-level timestamps from cross-attention alignment (DTW).

Counterpart of ``whisper_ipa_tpu/decode/word_timestamps.py``: a
teacher-forced forward over the decoded tokens returns the cross-attention
weights (``models/whisper.decoder_cross_attentions``, on the parameters'
device); the heads of the upper decoder layers are averaged, normalised per
token and median-filtered along time, and dynamic time warping (NumPy, on
the host) finds the monotonic token -> frame alignment. Token times are
projected onto IPA phones through the tokenizer's byte spans, giving
{"phone", "start", "end"}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import WhisperConfig
from ..metrics.segment import tokenize_ipa
from ..models.whisper import decoder_cross_attentions, encode
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import _device_of

FRAME_SECONDS = 0.02  # one encoder position = 2 mel hops = 20 ms


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (attention smoothing)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.stack(
        [xp[..., i:i + x.shape[-1]] for i in range(width)], axis=-1
    )
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray):
    """Monotonic alignment path minimizing total cost.

    cost: (n_tokens, n_frames). Returns (token_idx, frame_idx) arrays.
    Standard DTW with steps (1,1), (1,0), (0,1).
    """
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for i in range(1, n + 1):
        row_cost = cost[i - 1]
        for j in range(1, m + 1):
            c0 = D[i - 1, j - 1]
            c1 = D[i - 1, j]
            c2 = D[i, j - 1]
            best = min(c0, c1, c2)
            D[i, j] = row_cost[j - 1] + best
            trace[i, j] = 0 if best == c0 else (1 if best == c1 else 2)

    ti, fi = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


def token_alignment(
    params,
    cfg: WhisperConfig,
    tokens: Sequence[int],
    audio_features,
    tokenizer: WhisperTokenizer,
    medfilt_width: int = 7,
    n_frames: Optional[int] = None,
) -> np.ndarray:
    """(len(tokens), 2) start/end seconds for each decoded text token.

    tokens: the emitted text tokens (no SOT prefix, no EOT).
    n_frames: the audio's length in encoder frames (crops the window).
    """
    prefix = list(tokenizer.sot_sequence_including_notimestamps)
    full = prefix + [int(t) for t in tokens] + [tokenizer.eot]
    device = _device_of(params)
    with torch.inference_mode():
        tok_arr = torch.tensor([full], device=device)
        feats = torch.as_tensor(audio_features).to(device)
        _, weights = decoder_cross_attentions(params, cfg, tok_arr, feats)
        w = weights.float().cpu().numpy()  # (L, 1, H, T, T_a)

    # the upper half of the decoder carries the cleanest alignment signal
    upper = w[w.shape[0] // 2:, 0]  # (L/2, H, T, T_a)
    attn = upper.mean(axis=(0, 1))  # (T, T_a)
    if n_frames:
        attn = attn[:, :min(n_frames, attn.shape[1])]
    attn = attn / (attn.max(axis=-1, keepdims=True) + 1e-9)
    attn = median_filter(attn, medfilt_width)

    cost = -attn[len(prefix):len(prefix) + len(tokens)]
    if cost.shape[0] == 0:
        return np.zeros((0, 2))

    ti, fi = dtw_path(cost)
    bounds = np.zeros((len(tokens), 2))
    for t in range(len(tokens)):
        frames = fi[ti == t]
        if len(frames):
            bounds[t] = [frames.min(), frames.max() + 1]
        elif t > 0:
            bounds[t] = bounds[t - 1]
    return bounds * FRAME_SECONDS


def phone_timestamps(
    params,
    cfg: WhisperConfig,
    tokens: Sequence[int],
    mel_or_features,
    tokenizer: Optional[WhisperTokenizer] = None,
    audio_seconds: Optional[float] = None,
) -> List[Dict]:
    """Per-IPA-phone timing: [{"phone", "start", "end"}].

    tokens: the decoded text tokens of one 30 s window.
    mel_or_features: (1, 3000, n_mels) mel or (1, 1500, d) encoder output,
    a tensor or array; it runs on the parameters' device.
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual, num_languages=cfg.num_languages
        )
    with torch.inference_mode():
        feats = torch.as_tensor(mel_or_features).to(_device_of(params))
        if feats.dim() == 2:
            feats = feats[None]
        if feats.shape[-1] == cfg.n_mels:
            feats = encode(params, cfg, feats)

    n_frames = int(audio_seconds / FRAME_SECONDS) if audio_seconds else None
    bounds = token_alignment(params, cfg, tokens, feats, tokenizer,
                             n_frames=n_frames)

    # characters -> the token that produced them, at the BYTE level (one
    # UTF-8 character can span several byte-level BPE tokens)
    byte_token: List[int] = []
    data = b""
    for i, tok_id in enumerate(tokens):
        tid = int(tok_id)
        piece = (
            tokenizer.bpe.decode_bytes([tid]) if tid < tokenizer.n_base else b""
        )
        data += piece
        byte_token.extend([i] * len(piece))
    text = data.decode("utf-8", errors="replace")

    char_token: List[tuple] = []  # (first_token, last_token) per char
    bpos = 0
    for ch in text:
        blen = len(ch.encode("utf-8"))
        toks = byte_token[bpos:bpos + blen]
        if toks:
            char_token.append((toks[0], toks[-1]))
        else:
            char_token.append(char_token[-1] if char_token else (0, 0))
        bpos += blen

    out: List[Dict] = []
    pos = 0
    for phone in tokenize_ipa(text):
        # this phone's character span in the running text
        start_char = text.find(phone, pos)
        if start_char < 0:
            start_char = pos
        end_char = start_char + len(phone)
        pos = end_char
        spans = [char_token[c]
                 for c in range(start_char, min(end_char, len(char_token)))]
        if not spans:
            continue
        first_tok = min(s[0] for s in spans)
        last_tok = max(s[1] for s in spans)
        out.append({
            "phone": phone,
            "start": float(bounds[first_tok, 0]),
            "end": float(bounds[last_tok, 1]),
        })
    return out
