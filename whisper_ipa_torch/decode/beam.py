"""Batched beam search with a pool of finished hypotheses.

Counterpart of ``whisper_ipa_tpu/decode/beam.py`` (its default, reorder-free
loop ``_beam_decode_jit_v2``). Whisper's semantics: a hypothesis that emits
EOT moves to its sample's pool of finished candidates (scored with the GNMT
length penalty) and its slot goes to the best unfinished continuation;
decoding stops when every sample holds ``ceil(beam_size * patience)``
finished candidates or the length limit is hit. The answer is the best
pooled candidate, or the best active beam when nothing finished.

The self cache is never reordered: an ancestry table ``anc`` (B, K, n_ctx)
on the device routes each beam to its history rows inside the softmax
(``models/whisper.decode_step_beam``), and the beam-invariant cross cache
stays at batch B. Where the reference reorders by one-hot einsums (a TPU
layout choice), the port gathers; so its pooled log-probability sums stay
finite where the reference's einsum multiplies 0 by the pool's -inf slots
and returns NaN. The scores are f32 tensors, and every top-k is a stable
descending sort, so ties go to the lower index as in ``jax.lax.top_k``.

The loop asks the device whether every sample's pool is full only every
``BEAM_CHECK_EVERY`` steps; in between, a step taken after the pools filled
leaves the whole state as it was, so the result is the same as stopping at
once.

The reference's legacy loop (full cache reorder a step, under
``WHISPER_IPA_TPU_LEGACY_BEAM=1``) is an A/B of a TPU layout with the same
output contract and is not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.whisper import (
    cast_decoder_blocks,
    decode_step,
    decode_step_beam,
    init_cache,
)
from .decoding import (
    DecodingOptions,
    DecodingResult,
    apply_timestamp_rules,
    compression_ratio,
    sequence_score,
)

BEAM_CHECK_EVERY = 8


def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last axis: ties go to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gnmt_penalty(length: torch.Tensor, length_penalty: Optional[float]):
    if length_penalty is None:
        return torch.clamp_min(length, 1).float()
    return ((5.0 + length.float()) / 6.0) ** length_penalty


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) -> (B, M, ...): x[b, idx[b, m]]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return x.gather(1, idx)


def _merge_pool(n_pool, pool_sc, pool_sm, pool_ln, pool_tk,
                new_sc, new_sm, new_ln, new_tk):
    """Keep the best n_pool of (pool + new) by penalized score."""
    all_sc = torch.cat([pool_sc, new_sc], dim=1)  # (B, P + K)
    best_sc, best_idx = _top_k(all_sc, n_pool)
    return (
        best_sc,
        _gather_rows(torch.cat([pool_sm, new_sm], dim=1), best_idx),
        _gather_rows(torch.cat([pool_ln, new_ln], dim=1), best_idx),
        _gather_rows(torch.cat([pool_tk, new_tk], dim=1), best_idx),
    )


def _beam_decode(
    params,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,  # (B, T_a, d)
    prefix_tokens: torch.Tensor,  # (B, n_prefix)
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    eot: int,
    sample_len: int,
    beam_size: int,
    n_pool: int,
    length_penalty: Optional[float],
    timestamp_rules: bool,
    timestamp_begin: int,
    max_initial_ts_index: int,
    sot_index: int,
    cross_kv_int8: bool,
    cross_kv_int4: bool,
    dtype: torch.dtype,
    tp=None,
):
    """The reorder-free beam loop; returns (tokens (B, K, max_len),
    sum_logprobs (B, K), lengths (B, K), pool_scores, pool_sums, pool_lens
    (B, n_pool), pool_tokens (B, n_pool, max_len), sot_logits (B, V))."""
    params = cast_decoder_blocks(params, dtype)
    B, n_prefix = prefix_tokens.shape
    K = beam_size
    C = K + 1  # candidates a beam: at most one of them is EOT
    max_len = n_prefix + sample_len
    device = audio_features.device
    neg_inf = float("-inf")
    vocab_idx = torch.arange(suppress_mask.shape[0], device=device)
    beam_rows = torch.arange(K, device=device)

    def ts_filter(logits, step, prev_tok, prev2_tok, last_ts):
        if not timestamp_rules:
            return logits
        return apply_timestamp_rules(
            logits, vocab_idx, step, prev_tok, prev2_tok, last_ts, eot=eot,
            timestamp_begin=timestamp_begin,
            max_initial_ts_index=max_initial_ts_index,
        )

    # the prefix at batch B, then the self cache K-fold (every physical
    # row holds the same prefix, so anc[b, j, p] = j is right from the start)
    cache = init_cache(params, cfg, audio_features, max_len=max_len,
                       dtype=dtype, cross_kv_int8=cross_kv_int8,
                       cross_kv_int4=cross_kv_int4, tp=tp)
    prefix_logits, cache = decode_step(params, cfg, prefix_tokens, cache, 0,
                                       dtype=dtype, tp=tp)
    cache = cache._replace(self_k=cache.self_k.repeat_interleave(K, dim=1),
                           self_v=cache.self_v.repeat_interleave(K, dim=1))
    anc = beam_rows[None, :, None].repeat(B, 1, max_len)
    sot_logits = prefix_logits[:, sot_index]

    # the first expansion: the top K tokens of the prefix's logits
    last = prefix_tokens[:, -1]
    logits0 = ts_filter(
        prefix_logits[:, -1] + suppress_mask + blank_mask, 0, last,
        prefix_tokens[:, -2] if n_prefix >= 2 else last,
        torch.full_like(last, timestamp_begin - 1),
    )
    sum_logprobs, prev_tok = _top_k(torch.log_softmax(logits0, dim=-1), K)
    prev2_tok = last[:, None].repeat(1, K)
    last_ts = torch.where(prev_tok >= timestamp_begin, prev_tok,
                          timestamp_begin - 1)

    tokens = torch.full((B, K, max_len), eot, dtype=torch.long, device=device)
    tokens[:, :, :n_prefix] = prefix_tokens[:, None]
    tokens[:, :, n_prefix] = prev_tok
    lengths = torch.ones((B, K), dtype=torch.long, device=device)

    pool_scores = torch.full((B, n_pool), neg_inf, device=device)
    pool_sums = torch.zeros((B, n_pool), device=device)
    pool_lens = torch.zeros((B, n_pool), dtype=torch.long, device=device)
    pool_tokens = torch.full((B, n_pool, max_len), eot, dtype=torch.long,
                             device=device)

    logits, cache = decode_step_beam(params, cfg, prev_tok, cache, n_prefix,
                                     anc, dtype=dtype, tp=tp)

    def pools_full():
        return ((pool_scores > neg_inf).sum(dim=1) >= n_pool).all()

    for step in range(sample_len - 1):
        full = pools_full()
        if step % BEAM_CHECK_EVERY == 0 and bool(full):
            break

        # the loop's step 0 is the second sampled position
        filtered = ts_filter(logits + suppress_mask, step + 1, prev_tok,
                             prev2_tok, last_ts)
        cand_lp, cand_tok = _top_k(torch.log_softmax(filtered, dim=-1), C)
        flat_scores = (sum_logprobs[:, :, None] + cand_lp).reshape(B, K * C)
        flat_tok = cand_tok.reshape(B, K * C)
        is_eot = flat_tok == eot

        # finished candidates -> the pool
        fin_top, fin_idx = _top_k(flat_scores.masked_fill(~is_eot, neg_inf), K)
        parent = fin_idx // C
        fin_lens = lengths.gather(1, parent)
        fin_pen = fin_top / _gnmt_penalty(fin_lens, length_penalty)
        fin_pen = fin_pen.masked_fill(fin_top == neg_inf, neg_inf)
        new_pool = _merge_pool(n_pool, pool_scores, pool_sums, pool_lens,
                               pool_tokens, fin_pen, fin_top, fin_lens,
                               _gather_rows(tokens, parent))

        # unfinished candidates -> the new active beams; the cache stays,
        # only the ancestry table follows the beams, and beam j writes its
        # own K/V at physical row j at pos
        new_sums, unf_idx = _top_k(flat_scores.masked_fill(is_eot, neg_inf), K)
        new_tok = flat_tok.gather(1, unf_idx)
        beam_idx = unf_idx // C
        pos = n_prefix + step + 1
        new_anc = _gather_rows(anc, beam_idx)
        new_anc[:, :, pos] = beam_rows
        new_tokens = _gather_rows(tokens, beam_idx)
        new_tokens[:, :, pos] = new_tok
        new_last_ts = last_ts.gather(1, beam_idx)
        new_state = (
            new_tokens, lengths.gather(1, beam_idx) + 1, new_sums, new_anc,
            new_tok, prev_tok.gather(1, beam_idx),
            torch.where(new_tok >= timestamp_begin, new_tok, new_last_ts),
            *new_pool,
        )
        # a step after every pool filled changes nothing
        (tokens, lengths, sum_logprobs, anc, prev_tok, prev2_tok, last_ts,
         pool_scores, pool_sums, pool_lens, pool_tokens) = (
            torch.where(full, old, new) for old, new in zip(
                (tokens, lengths, sum_logprobs, anc, prev_tok, prev2_tok,
                 last_ts, pool_scores, pool_sums, pool_lens, pool_tokens),
                new_state)
        )
        logits, cache = decode_step_beam(params, cfg, prev_tok, cache, pos,
                                         anc, dtype=dtype, tp=tp)
    return (tokens, sum_logprobs, lengths, pool_scores, pool_sums, pool_lens,
            pool_tokens, sot_logits)


def beam_decode(
    params,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,
    prefix: List[int],
    options: DecodingOptions,
    tokenizer,
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    prefix_tokens: Optional[torch.Tensor] = None,
    sot_index: int = 0,
    max_initial_ts_index: int = 50,
    detected_langs: Optional[List[str]] = None,
    tp=None,
) -> List[DecodingResult]:
    """Beam-search ``audio_features`` (B, T_a, d) on their device; one
    DecodingResult a row. ``decode()`` calls it when ``beam_size`` is set."""
    B = audio_features.shape[0]
    n_prefix = len(prefix)
    sample_len = options.sample_len or (cfg.n_text_ctx // 2)
    sample_len = min(sample_len, cfg.n_text_ctx - n_prefix)
    device = audio_features.device
    if prefix_tokens is None:
        prefix_tokens = torch.tensor(prefix, device=device)[None].repeat(B, 1)
    K = int(options.beam_size)
    patience = float(options.patience) if options.patience else 1.0
    n_pool = max(K, int(math.ceil(K * patience)))
    blank = blank_mask if options.suppress_blank else torch.zeros_like(
        suppress_mask)

    with torch.inference_mode():
        out = _beam_decode(
            params, cfg, audio_features, prefix_tokens, suppress_mask, blank,
            tokenizer.eot, int(sample_len), K, n_pool, options.length_penalty,
            timestamp_rules=not options.without_timestamps,
            timestamp_begin=tokenizer.timestamp_begin,
            max_initial_ts_index=max_initial_ts_index, sot_index=sot_index,
            cross_kv_int8=options.kv_int8, cross_kv_int4=options.kv_int4,
            dtype=torch.bfloat16 if options.fp16 else torch.float32,
            tp=tp,
        )
        no_speech = torch.softmax(out[-1], dim=-1)[:, tokenizer.no_speech]
        (tokens_np, sums_np, lengths_np, pool_scores_np, pool_sums_np,
         pool_lens_np, pool_tokens_np) = (t.cpu().numpy() for t in out[:-1])
        no_speech_np = no_speech.float().cpu().numpy()

    results = []
    for b in range(B):
        if (pool_scores_np[b] > -np.inf).any():
            k = int(np.argmax(pool_scores_np[b]))
            length = int(pool_lens_np[b, k])
            seq = pool_tokens_np[b, k, n_prefix:n_prefix + length].tolist()
            total_lp = float(pool_sums_np[b, k])
        else:
            # nothing finished within the length limit: the best active beam
            scores = [sequence_score(float(sums_np[b, k]),
                                     int(lengths_np[b, k]),
                                     options.length_penalty)
                      for k in range(K)]
            k = int(np.argmax(scores))
            seq_full = tokens_np[b, k, n_prefix:]
            eot_pos = np.nonzero(seq_full == tokenizer.eot)[0]
            length = int(eot_pos[0]) if len(eot_pos) else len(seq_full)
            seq = seq_full[:length].tolist()
            total_lp = float(sums_np[b, k])
        text = tokenizer.decode_text(seq).strip()
        results.append(
            DecodingResult(
                tokens=seq,
                text=text,
                avg_logprob=total_lp / (length + 1),
                no_speech_prob=float(no_speech_np[b]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
                language=(
                    detected_langs[b] if detected_langs
                    else options.language or tokenizer.language
                ),
            )
        )
    return results
