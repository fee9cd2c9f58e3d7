"""Teacher-forced cross-entropy with the first-EOT-kept mask.

Counterpart of ``whisper_ipa_tpu/train/loss.py``. Padding uses the EOT
token, so the loss keeps exactly the FIRST EOT of each target row (the
model must learn to stop) and masks the rest: a cumulative sum over the
EOT indicator marks the first one as cumsum == 1.

A frozen encoder runs under ``torch.no_grad()`` (the reference's
``stop_gradient``), so no encoder activations are kept for a backward.
``compute_distill_loss`` trains a speculative-decoding draft toward a
frozen teacher (``cli/distill_draft.py``).
"""

from __future__ import annotations

import torch

from ..config import WhisperConfig
from ..models.whisper import decoder_hidden, decoder_logits, encode
from ..ops.blockwise_ce import blockwise_cross_entropy


def eot_loss_mask(target_tokens, eot: int):
    """True where loss is computed: non-EOT tokens plus the first EOT."""
    is_eot = target_tokens == eot
    eot_cumsum = torch.cumsum(is_eot.to(torch.int32), dim=1)
    return (~is_eot) | (eot_cumsum == 1)


def masked_cross_entropy(logits, targets, mask):
    """Mean CE over masked positions. logits float32 (B, T, V)."""
    logprobs = torch.log_softmax(logits, dim=-1)
    token_lp = logprobs.gather(-1, targets[..., None].long())[..., 0]
    losses = -token_lp * mask.to(logits.dtype)
    num_valid = mask.sum().clamp_min(1)
    return losses.sum() / num_valid


def compute_loss(
    params,
    cfg: WhisperConfig,
    mel,
    tokens,
    eot: int,
    *,
    audio_features=None,
    freeze_encoder: bool = True,
    dtype=torch.float32,
    remat: bool = False,
    blockwise: bool = False,
    bf16_head: bool = False,
):
    """CE loss for a batch.

    mel: (B, 2 * n_audio_ctx, n_mels); tokens: (B, S) with the SOT
    sequence + IPA + EOT padding. ``audio_features`` (B, n_audio_ctx, d)
    replaces the encoder when given (cached frozen-encoder features).
    """
    if audio_features is None:
        if freeze_encoder:
            with torch.no_grad():
                audio_features = encode(params, cfg, mel, dtype=dtype)
        else:
            audio_features = encode(params, cfg, mel, dtype=dtype, remat=remat)

    decoder_input = tokens[:, :-1]
    target_tokens = tokens[:, 1:]
    mask = eot_loss_mask(target_tokens, eot)

    if blockwise:
        # memory-efficient path: never materializes (B, T, V) logits
        hidden = decoder_hidden(
            params, cfg, decoder_input, audio_features, dtype=dtype,
            remat=remat,
        )
        B, T, d = hidden.shape
        return blockwise_cross_entropy(
            hidden.float().reshape(B * T, d),
            params["decoder"]["token_embedding"],
            target_tokens.reshape(B * T),
            mask.reshape(B * T),
        )

    logits = decoder_logits(
        params, cfg, decoder_input, audio_features, dtype=dtype,
        remat=remat, bf16_head=bf16_head,
    )
    return masked_cross_entropy(logits, target_tokens, mask)


def compute_distill_loss(
    student_params,
    teacher_params,
    student_cfg: WhisperConfig,
    teacher_cfg: WhisperConfig,
    mel,
    tokens,
    eot: int,
    *,
    alpha: float = 0.5,
    temperature: float = 2.0,
    dtype=torch.float32,
):
    """Draft distillation: (1 - alpha) * CE(student, data) + alpha * T^2 *
    KL(teacher_T || student_T), both over the first-EOT-kept mask (Hinton
    et al. 2015's scaling).

    Speculative acceptance measures draft-target agreement, so the draft
    learns the target's distribution and not only the data. The teacher
    runs under ``torch.no_grad()`` (frozen); the two models may differ in
    size but share the vocabulary and the mel shape.
    """
    if student_cfg.n_vocab != teacher_cfg.n_vocab:
        raise ValueError("student and teacher must share the vocabulary")

    decoder_input = tokens[:, :-1]
    target_tokens = tokens[:, 1:]
    mask = eot_loss_mask(target_tokens, eot)

    s_feats = encode(student_params, student_cfg, mel, dtype=dtype)
    s_logits = decoder_logits(
        student_params, student_cfg, decoder_input, s_feats, dtype=dtype
    )
    with torch.no_grad():
        t_feats = encode(teacher_params, teacher_cfg, mel, dtype=dtype)
        t_logits = decoder_logits(
            teacher_params, teacher_cfg, decoder_input, t_feats, dtype=dtype
        )

    ce = masked_cross_entropy(s_logits, target_tokens, mask)

    T = temperature
    t_lp = torch.log_softmax(t_logits / T, dim=-1)
    s_lp = torch.log_softmax(s_logits / T, dim=-1)
    kl_tok = (torch.exp(t_lp) * (t_lp - s_lp)).sum(-1)  # (B, T)
    num_valid = mask.sum().clamp_min(1)
    kl = (kl_tok * mask.to(kl_tok.dtype)).sum() / num_valid

    return (1.0 - alpha) * ce + alpha * (T * T) * kl
