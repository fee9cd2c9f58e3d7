"""Analytic FLOPs of Whisper's forward, cached decode and training step.

The formulas of the program's ``utils/flops.py`` (multiply-accumulates
count 2), copied here so the yardstick stays fixed. The log-mel frontend
is left out of the model's FLOPs (the program's ``mel_flops`` counts a
matmul DFT that its kernel no longer runs).
"""

from __future__ import annotations


def encoder_flops(n_mels: int, d: int, n_layer: int, n_ctx: int = 1500) -> float:
    """Encoder forward of one 30 s window: the two convolutions and the
    pre-LN blocks (projections, scores and values, MLP d -> 4d -> d)."""
    T = n_ctx
    conv1 = 2.0 * (2 * T) * 3 * n_mels * d
    conv2 = 2.0 * T * 3 * d * d
    per_layer = 8.0 * T * d * d + 4.0 * T * T * d + 16.0 * T * d * d
    return conv1 + conv2 + n_layer * per_layer


def decoder_flops(d: int, n_layer: int, n_vocab: int, n_positions: int,
                  n_audio_ctx: int = 1500) -> float:
    """Cached decode over ``n_positions`` positions of one row: the cross
    K/V projections once, every position's projections, MLP, cross scores
    and values and logits, and the self-attention window growing 1..n."""
    n = n_positions
    cross_kv_once = 4.0 * n_audio_ctx * d * d * n_layer
    per_token_layer = 8.0 * d * d + 4.0 * d * d + 16.0 * d * d + 4.0 * n_audio_ctx * d
    self_window = 4.0 * d * (n * (n + 1) / 2.0) * n_layer
    logits = 2.0 * d * n_vocab * n
    return cross_kv_once + per_token_layer * n_layer * n + self_window + logits


def train_step_flops(n_mels: int, d: int, n_layer: int, n_vocab: int,
                     token_len: int, n_audio_ctx: int = 1500) -> float:
    """One decoder-only training step of one sample: the frozen encoder's
    forward, and the decoder's forward and backward (twice the forward)
    over ``token_len`` teacher-forced positions."""
    n = token_len
    dec_fwd = (
        4.0 * n_audio_ctx * d * d * n_layer
        + (28.0 * d * d + 4.0 * n_audio_ctx * d) * n_layer * n
        + 4.0 * d * (n * n / 2.0) * n_layer
        + 2.0 * d * n_vocab * n
    )
    return encoder_flops(n_mels, d, n_layer, n_audio_ctx) + 3.0 * dec_fwd
