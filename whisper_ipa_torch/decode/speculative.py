"""Speculative decoding: a draft proposes K tokens, the target verifies them
in one forward.

Counterpart of ``whisper_ipa_tpu/decode/speculative.py``. Three draft
sources propose K tokens a round:

- a draft model (e.g. whisper-tiny): K + 1 autoregressive single-query
  steps on its own cache (the extra step only ingests d_K, so its K/V is
  in the draft cache when full acceptance moves the frontier past it);
- n-gram lookup (``draft_params=None``): the continuation of the latest
  earlier occurrence of the current trigram, else bigram, in the tokens
  emitted so far (prompt-lookup decoding), at no model cost;
- Medusa heads (``medusa_params``): K residual heads on the frontier
  hidden state propose all K at once (``models/medusa.py``).

The target then scores the block [last token, d_1 .. d_K] at positions
lens - 1 .. lens - 1 + K in one (K + 1)-query forward
(``decode_step_multipos``) and accepts the longest prefix of drafts equal
to its own greedy choices, plus one token of its own (the correction at the
first mismatch, or a bonus when all matched). At temperature 0 the tokens
are therefore exactly ``decode()``'s; the draft changes only the number of
rounds. Each row accepts its own count, so lengths, masks, positions and
cache writes are per row. Stale K/V written for rejected drafts is never
read: the causal mask hides rows at or past each row's frontier, and the
next round re-feeds the last emitted token over them.

The reference runs the round loop as one ``lax.while_loop``; here it is an
eager loop on device tensors, with no host read inside a round. As in
``decoding._greedy_decode`` the host asks whether every row has finished
only every ``FINISHED_CHECK_EVERY`` rounds; the rounds past the end emit
nothing, and ``rounds`` counts only rounds in which some row was active,
so ``SpeculativeStats`` is the reference's.

Over a tensor-parallel group (``tp``) the target's forwards run on the
rank's Megatron blocks while the draft model and the heads run whole on
every rank (replicated, as the reference replicates them); the logits and
the frontier hidden are all-reduced, so every rank drafts, accepts and
stops alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.medusa import medusa_propose
from ..models.whisper import (
    cast_decoder_blocks,
    decode_step,
    decode_step_multipos,
    decode_step_multipos_hidden,
    encode,
    init_cache,
)
from ..ops.precision import full_fp32
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import (
    FINISHED_CHECK_EVERY,
    DecodingOptions,
    DecodingResult,
    _device_of,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    detect_language,
    initial_tokens,
)


@dataclass
class SpeculativeStats:
    """Accept-rate accounting for one speculative call."""

    rounds: int
    emitted_tokens: int  # across the batch, excluding post-finish padding
    draft_k: int
    batch: int = 1

    @property
    def tokens_per_round(self) -> float:
        """Mean tokens emitted per element per verification round
        (1.0 = nothing accepted; draft_k + 1 = everything accepted)."""
        return self.emitted_tokens / max(self.rounds * self.batch, 1)


def _ngram_drafts(tokens_buf, lens, K: int):
    """Model-free drafts (B, K): continue the latest earlier occurrence of
    the current trigram, else of the bigram, else repeat the last token.
    tokens_buf: (B, L) long; lens: (B,) long, the emitted length of each
    row. Verification keeps the output exact whatever these propose."""
    B, L = tokens_buf.shape
    idx = torch.arange(L, device=tokens_buf.device)

    def last(n):
        return tokens_buf.gather(1, (lens - n).clamp_min(0)[:, None])  # (B, 1)

    last1, last2, last3 = last(1), last(2), last(3)
    match2 = (tokens_buf[:, :-1] == last2) & (tokens_buf[:, 1:] == last1)
    valid2 = idx[None, :-1] + 1 < (lens - 1)[:, None]
    j2 = torch.where(match2 & valid2, idx[None, :-1], -1).amax(dim=1)
    # the trigram buf[j .. j + 2] == (last3, last2, last1) continues at j + 3
    match3 = ((tokens_buf[:, :-2] == last3) & (tokens_buf[:, 1:-1] == last2)
              & (tokens_buf[:, 2:] == last1))
    valid3 = idx[None, :-2] + 2 < (lens - 1)[:, None]
    j3 = torch.where(match3 & valid3, idx[None, :-2], -1).amax(dim=1)

    use3 = j3 >= 0
    found = use3 | (j2 >= 0)
    starts = torch.where(use3, j3 + 3, torch.where(j2 >= 0, j2 + 2, 0))
    gather_idx = (starts[:, None] + idx[None, :K]).clamp_max(L - 1)
    drafts = tokens_buf.gather(1, gather_idx)
    return torch.where(found[:, None], drafts, last1)


def _accept(emit, m, lens, finished, n_prefix: int, sample_len: int, eot: int):
    """The round's emitted count v (B,): the m matched tokens and the one
    that follows them, cut after the first EOT and at the sample_len
    budget; 0 for finished rows. Returns (v, whether the emitted tokens
    hold an EOT)."""
    idx = torch.arange(emit.shape[1], device=emit.device)[None, :]
    eot_hit = (emit == eot) & (idx <= m[:, None])
    any_eot = eot_hit.any(dim=1)
    first_eot = eot_hit.to(torch.uint8).argmax(dim=1)
    v = torch.where(any_eot, first_eot + 1, m + 1)
    v = torch.minimum(v, sample_len - (lens - n_prefix))
    v = torch.where(finished, 0, v)
    return v, any_eot & (first_eot < v)


def _emit(tokens_buf, lens, emit, emit_lp, v, sum_logprobs, eot: int):
    """Write the first v[b] emitted tokens of each row at lens[b] (the rest
    of the (B, K + 1) block as EOT, in one scatter) and add their
    log-probabilities. Returns the new sum_logprobs."""
    B, S = emit.shape
    idx = torch.arange(S, device=emit.device)[None, :]
    keep = idx < v[:, None]
    rows = torch.arange(B, device=emit.device)[:, None]
    tokens_buf[rows, lens[:, None] + idx] = torch.where(keep, emit, eot)
    return sum_logprobs + torch.where(keep, emit_lp, 0.0).sum(dim=1)


def _spec_decode(
    params,
    draft_params,
    cfg: WhisperConfig,
    draft_cfg: WhisperConfig,
    audio_features,
    draft_features,
    prefix_tokens,  # (B, n_prefix) long
    suppress_mask,  # (n_vocab,) f32
    blank_mask,  # (n_vocab,) f32
    eot: int,
    sample_len: int,
    draft_k: int,
    dtype: torch.dtype,
    sot_index: int,
    cross_kv_int8: bool,
    cross_kv_int4: bool,
    ngram: bool,
    medusa_params,
    tp=None,
):
    """The batched round loop; returns (tokens (B, buf_len), sum_logprobs
    (B,), sot_logits (B, n_vocab), rounds, emitted), the last two 0-d
    device tensors. ``tp``: the target's tensor-parallel group; the draft
    model and the heads are replicated and run whole on every rank."""
    medusa = medusa_params is not None
    params = cast_decoder_blocks(params, dtype)
    if draft_params is not None:
        draft_params = cast_decoder_blocks(draft_params, dtype)
    K = draft_k
    B, n_prefix = prefix_tokens.shape
    device = audio_features.device
    buf_len = n_prefix + sample_len + K + 1

    tcache = init_cache(
        params, cfg, audio_features, max_len=buf_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4, tp=tp,
    )
    if medusa:
        prefix_logits, tcache, prefix_hidden = decode_step_multipos_hidden(
            params, cfg, prefix_tokens, tcache,
            torch.zeros(B, dtype=torch.long, device=device), dtype=dtype,
            tp=tp,
        )
        # head k on h_t proposes token t + k + 2: the first round drafts
        # slots n_prefix.., so it starts from h at n_prefix - 2
        hidden_frontier = prefix_hidden[:, n_prefix - 2]
    else:
        prefix_logits, tcache = decode_step(
            params, cfg, prefix_tokens, tcache, 0, dtype=dtype, tp=tp
        )
    dcache = None
    if not (ngram or medusa):
        dcache = init_cache(draft_params, draft_cfg, draft_features,
                            max_len=buf_len, dtype=dtype)
        _, dcache = decode_step(draft_params, draft_cfg, prefix_tokens,
                                dcache, 0, dtype=dtype)
    sot_logits = prefix_logits[:, sot_index]

    tokens_buf = torch.full((B, buf_len), eot, dtype=torch.long, device=device)
    tokens_buf[:, :n_prefix] = prefix_tokens
    lens = torch.full((B,), n_prefix, dtype=torch.long, device=device)
    last_tok = prefix_tokens[:, -1].clone()
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros(B, dtype=torch.float32, device=device)
    rounds = torch.zeros((), dtype=torch.long, device=device)
    emitted = torch.zeros((), dtype=torch.long, device=device)
    idx = torch.arange(K + 1, device=device)[None, :]

    # every active round emits a token for every active row, so sample_len
    # rounds finish every row (the reference's bound on its while_loop)
    for it in range(sample_len):
        if it and it % FINISHED_CHECK_EVERY == 0 and bool(finished.all()):
            break
        rounds = rounds + (~finished).any()

        # -- draft: propose K tokens
        if medusa:
            drafts = medusa_propose(medusa_params, params, hidden_frontier,
                                    dtype)
        elif ngram:
            drafts = _ngram_drafts(tokens_buf, lens, K)
        else:
            tok, pos, steps = last_tok, lens - 1, []
            for _ in range(K + 1):  # the last step only ingests d_K
                logits, dcache = decode_step_multipos(
                    draft_params, draft_cfg, tok[:, None], dcache, pos,
                    dtype=dtype,
                )
                lg = logits[:, 0] + suppress_mask
                # the token being predicted sits at slot pos + 1
                lg = torch.where((pos + 1 == n_prefix)[:, None],
                                 lg + blank_mask, lg)
                tok, pos = lg.argmax(dim=-1), pos + 1
                steps.append(tok)
            drafts = torch.stack(steps[:K], dim=1)

        # -- target: verify the K drafts in one (K + 1)-query forward
        block = torch.cat([last_tok[:, None], drafts], dim=1)
        tlogits, tcache, block_hidden = decode_step_multipos_hidden(
            params, cfg, block, tcache, lens - 1, dtype=dtype, tp=tp
        )
        # tlogits[:, i] predicts the token at slot lens + i
        lg = tlogits + suppress_mask
        lg = torch.where(((lens[:, None] + idx) == n_prefix)[..., None],
                         lg + blank_mask, lg)
        emit = lg.argmax(dim=-1)  # (B, K + 1): the target's greedy choices
        emit_lp = torch.log_softmax(lg, dim=-1).gather(
            -1, emit[..., None])[..., 0]
        # accepted drafts a: the drafts equal the greedy choices up to the
        # first mismatch; emit[i] for i <= a is the output
        a = torch.cumprod((emit[:, :K] == drafts).long(), dim=1).sum(dim=1)
        v, has_eot = _accept(emit, a, lens, finished, n_prefix, sample_len,
                             eot)
        sum_logprobs = _emit(tokens_buf, lens, emit, emit_lp, v,
                             sum_logprobs, eot)
        last_emit = emit.gather(1, (v - 1).clamp_min(0)[:, None])[:, 0]
        last_tok = torch.where(v >= 1, last_emit, last_tok)
        lens = lens + v
        finished = finished | has_eot | (lens - n_prefix >= sample_len)
        emitted = emitted + v.sum()
        if medusa:
            # the next heads start from the hidden of the input at (new
            # lens) - 2, block index v - 1 (v >= 1 for an active row)
            new_hf = block_hidden[torch.arange(B, device=device),
                                  (v - 1).clamp_min(0)]
            hidden_frontier = torch.where((v >= 1)[:, None], new_hf,
                                          hidden_frontier)
    return tokens_buf, sum_logprobs, sot_logits, rounds, emitted


# -- shared by speculative_decode and medusa_tree_decode ---------------------

def check_greedy_options(options: DecodingOptions, name: str) -> None:
    """Speculation reproduces greedy decoding without timestamps only."""
    if options.temperature != 0.0:
        raise ValueError(f"{name} requires temperature == 0")
    if not options.without_timestamps:
        raise ValueError(f"{name} requires without_timestamps=True")
    if options.beam_size is not None or options.best_of is not None:
        raise ValueError(f"{name} excludes beam_size/best_of")


def _as_mel(mel, device):
    mel = torch.as_tensor(mel).to(device)
    return mel[None] if mel.dim() == 2 else mel


class _Setup:
    """What both speculative decoders take from ``decode()``: the
    tokenizer, dtype, the target's encoder output, the prefix (language
    detected per row when asked), the masks."""

    def __init__(self, params, cfg, mel, options, tokenizer, tp=None):
        if tokenizer is None:
            tokenizer = get_tokenizer(
                multilingual=cfg.multilingual,
                num_languages=cfg.num_languages,
                language=options.language or "en",
                task=options.task,
            )
        self.tokenizer = tokenizer
        self.dtype = torch.bfloat16 if options.fp16 else torch.float32
        self.device = device = _device_of(params)
        self.audio_features = encode(params, cfg, _as_mel(mel, device),
                                     dtype=self.dtype, tp=tp)
        prefix = initial_tokens(tokenizer, options)
        self.n_prefix = len(prefix)
        self.sot_index = prefix.index(tokenizer.sot)
        B = self.audio_features.shape[0]
        self.prefix_tokens = torch.tensor(prefix, device=device)[None].repeat(B, 1)
        self.detected_langs = None
        if options.language is None and cfg.multilingual:
            self.detected_langs, _ = detect_language(
                params, cfg, self.audio_features, tokenizer, tp=tp
            )
            self.prefix_tokens[:, 1] = torch.tensor(
                [tokenizer.language_token(c) for c in self.detected_langs],
                device=device,
            )
        self.suppress_mask = torch.from_numpy(
            build_suppress_mask(tokenizer, options, cfg.n_vocab)
        ).to(device)
        self.blank_mask = (
            torch.from_numpy(build_blank_mask(tokenizer, cfg.n_vocab))
            if options.suppress_blank
            else torch.zeros(cfg.n_vocab)
        ).to(device)

    def results(self, options, tokens, sum_logprobs, sot_logits,
                sample_len: int) -> List[DecodingResult]:
        tok = self.tokenizer
        no_speech = torch.softmax(sot_logits.float(), dim=-1)[:, tok.no_speech]
        tokens_np = tokens.cpu().numpy()
        sum_logprobs_np = sum_logprobs.cpu().numpy()
        no_speech_np = no_speech.cpu().numpy()
        out = []
        for b in range(tokens_np.shape[0]):
            seq = tokens_np[b, self.n_prefix:]
            eot_pos = np.nonzero(seq == tok.eot)[0]
            end = min(int(eot_pos[0]) if len(eot_pos) else len(seq),
                      sample_len)
            out_tokens = seq[:end].tolist()
            text = tok.decode_text(out_tokens).strip()
            out.append(DecodingResult(
                tokens=out_tokens,
                text=text,
                avg_logprob=float(sum_logprobs_np[b]) / (end + 1),
                no_speech_prob=float(no_speech_np[b]),
                temperature=0.0,
                compression_ratio=compression_ratio(text),
                language=(
                    self.detected_langs[b] if self.detected_langs
                    else options.language or tok.language
                ),
            ))
        return out


def speculative_decode(
    params,
    cfg: WhisperConfig,
    draft_params,
    draft_cfg: Optional[WhisperConfig],
    mel,
    options: DecodingOptions = DecodingOptions(),
    draft_k: int = 4,
    draft_mel=None,
    tokenizer: Optional[WhisperTokenizer] = None,
    return_stats: bool = False,
    medusa_params=None,
    *,
    tp=None,
) -> List[DecodingResult]:
    """Greedy decode of ``mel`` with ``params``, accelerated by speculation;
    the tokens are exactly ``decode(params, cfg, mel, options)``'s.

    Draft sources: a draft model (``draft_params``/``draft_cfg``, on the
    parameters' device; ``draft_mel`` is its log-mel and is required when
    its ``n_mels`` differs from the target's), n-gram lookup
    (``draft_params=None``), or Medusa heads (``medusa_params``; ``draft_k``
    is then the number of heads). Requires greedy decoding without
    timestamps: ``temperature == 0``, ``without_timestamps=True``, no beam
    or best-of. With ``return_stats`` returns (results, SpeculativeStats).

    tp: the target's tensor-parallel group (``mesh.tp``) when ``params``
    are the rank's Megatron blocks, as in ``decode()``; the draft model
    and the heads stay whole (replicated), so every rank of the group
    drafts alike, and every rank gets the same tokens.
    """
    medusa = medusa_params is not None
    ngram = draft_params is None and not medusa
    if medusa and draft_params is not None:
        raise ValueError("medusa_params excludes a draft model")
    if medusa:
        draft_k = len(medusa_params["heads"])
    check_greedy_options(options, "speculative_decode")
    if ngram or medusa:
        draft_cfg = cfg  # context-length bookkeeping only
    elif draft_cfg.n_vocab != cfg.n_vocab or (
        draft_cfg.multilingual != cfg.multilingual
    ):
        raise ValueError(
            "draft and target models must share the tokenizer "
            f"(vocab {draft_cfg.n_vocab} vs {cfg.n_vocab})"
        )

    with torch.inference_mode(), full_fp32():
        setup = _Setup(params, cfg, mel, options, tokenizer, tp=tp)
        draft_features = None
        if not (ngram or medusa):
            if draft_mel is None:
                if draft_cfg.n_mels != cfg.n_mels:
                    raise ValueError(
                        "draft_mel is required when the models use different "
                        f"mel sizes ({draft_cfg.n_mels} vs {cfg.n_mels})"
                    )
                draft_mel = mel
            draft_features = encode(draft_params, draft_cfg,
                                    _as_mel(draft_mel, setup.device),
                                    dtype=setup.dtype)

        sample_len = options.sample_len or (cfg.n_text_ctx // 2)
        # the verification block runs up to K positions past the last
        # emitted token; keep every position inside both models' contexts
        max_ctx = min(cfg.n_text_ctx, draft_cfg.n_text_ctx)
        sample_len = min(sample_len, max_ctx - setup.n_prefix - draft_k - 1)

        tokens, sum_logprobs, sot_logits, rounds, emitted = _spec_decode(
            params, draft_params, cfg, draft_cfg, setup.audio_features,
            draft_features, setup.prefix_tokens, setup.suppress_mask,
            setup.blank_mask, setup.tokenizer.eot, int(sample_len),
            int(draft_k), setup.dtype, setup.sot_index, options.kv_int8,
            options.kv_int4, ngram, medusa_params, tp=tp,
        )
        results = setup.results(options, tokens, sum_logprobs, sot_logits,
                                sample_len)
        stats = SpeculativeStats(rounds=int(rounds), emitted_tokens=int(emitted),
                                 draft_k=draft_k, batch=len(results))
    if return_stats:
        return results, stats
    return results
