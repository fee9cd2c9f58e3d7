"""Autoregressive decoding: options, logit masks, the greedy/sampling loop.

Counterpart of ``whisper_ipa_tpu/decode/decoding.py``. The reference runs
the token loop as one ``lax.while_loop``; here it is an eager Python loop
over ``decode_step`` with the same state (token buffer, finished mask,
summed log-probabilities) and the same masking rules. It asks the device
whether every row has finished only every ``FINISHED_CHECK_EVERY`` tokens,
not every token: steps past the end write EOT over EOT and add nothing to
the scores, so the result is the same as stopping at once.

Not ported yet (``decode`` raises ``NotImplementedError``): beam search,
best-of-N sampling, the int4 cross cache, language detection
(``language=None`` on a multilingual model) and the timestamp rules.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from whisper_ipa_tpu.config import WhisperConfig
from whisper_ipa_tpu.tokenizer import WhisperTokenizer, get_tokenizer

from ..models.whisper import cast_decoder_blocks, decode_step, encode, init_cache
from ..ops.precision import full_fp32

FINISHED_CHECK_EVERY = 8


@dataclass(frozen=True)
class DecodingOptions:
    """Reference-compatible decoding options (same fields and defaults as
    ``whisper_ipa_tpu.decode.DecodingOptions``); ``fp16`` means bfloat16."""

    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = False
    seed: int = 0
    kv_int8: bool = False
    kv_int4: bool = False


@dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    audio_features: Optional[np.ndarray] = None
    language: Optional[str] = None


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# -- suppression masks ----------------------------------------------------

def build_suppress_mask(
    tokenizer: WhisperTokenizer, options: DecodingOptions, n_vocab: int
) -> np.ndarray:
    """Additive mask (n_vocab,) with -inf at always-suppressed ids."""
    suppress: set = set()
    opt = options.suppress_tokens
    if isinstance(opt, str):
        if opt == "-1":
            suppress.update(tokenizer.non_speech_tokens)
    elif opt:
        ids = [int(t) for t in opt]
        if -1 in ids:
            suppress.update(tokenizer.non_speech_tokens)
            ids = [t for t in ids if t != -1]
        suppress.update(ids)
    suppress.update(
        [
            tokenizer.transcribe,
            tokenizer.translate,
            tokenizer.sot,
            tokenizer.sot_prev,
            tokenizer.sot_lm,
            tokenizer.no_speech,
        ]
    )
    mask = np.zeros((n_vocab,), dtype=np.float32)
    mask[sorted(i for i in suppress if i < n_vocab)] = -np.inf
    if options.without_timestamps:
        mask[tokenizer.no_timestamps] = -np.inf
        mask[tokenizer.timestamp_begin:] = -np.inf
    return mask


def build_blank_mask(tokenizer: WhisperTokenizer, n_vocab: int) -> np.ndarray:
    """-inf at {space, EOT}: applied only at the first sampled position."""
    mask = np.zeros((n_vocab,), dtype=np.float32)
    for t in tokenizer.encode(" ") + [tokenizer.eot]:
        if t < n_vocab:
            mask[t] = -np.inf
    return mask


def initial_tokens(
    tokenizer: WhisperTokenizer, options: DecodingOptions
) -> List[int]:
    if options.without_timestamps:
        seq = list(tokenizer.sot_sequence_including_notimestamps)
    else:
        seq = list(tokenizer.sot_sequence)
    if options.prefix is not None:
        prefix = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str)
            else list(options.prefix)
        )
        seq = seq + prefix
    if options.prompt is not None:
        prompt = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str)
            else list(options.prompt)
        )
        seq = [tokenizer.sot_prev] + prompt[-(448 // 2 - 1):] + seq
    return seq


def sequence_score(
    sum_logprob: float, length: int, length_penalty: Optional[float]
) -> float:
    """MaximumLikelihoodRanker penalty (Whisper/GNMT convention)."""
    if length_penalty is None:
        penalty = max(length, 1)
    else:
        penalty = ((5.0 + length) / 6.0) ** length_penalty
    return sum_logprob / penalty


# -- greedy / sampling loop -----------------------------------------------

def _greedy_decode(
    params,
    cfg: WhisperConfig,
    audio_features: torch.Tensor,
    prefix_tokens: torch.Tensor,  # (B, n_prefix) int64
    suppress_mask: torch.Tensor,  # (n_vocab,) f32
    blank_mask: torch.Tensor,  # (n_vocab,) f32
    eot: int,
    sample_len: int,
    temperature: float,
    generator: Optional[torch.Generator],
    dtype: torch.dtype,
    sot_index: int,
    cross_kv_int8: bool,
):
    """Batched greedy/temperature decode; returns (tokens (B, n_prefix +
    sample_len), sum_logprobs (B,), sot_logits (B, n_vocab))."""
    # one cast before the loop, as the reference does outside its loop
    params = cast_decoder_blocks(params, dtype)
    B, n_prefix = prefix_tokens.shape
    max_len = n_prefix + sample_len
    cache = init_cache(
        params, cfg, audio_features, max_len=max_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8,
    )
    prefix_logits, cache = decode_step(
        params, cfg, prefix_tokens, cache, 0, dtype=dtype
    )
    sot_logits = prefix_logits[:, sot_index]
    logits = prefix_logits[:, -1]

    device = audio_features.device
    tokens = torch.full((B, max_len), eot, dtype=torch.long, device=device)
    tokens[:, :n_prefix] = prefix_tokens
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros(B, dtype=torch.float32, device=device)

    for step in range(sample_len):
        if step and step % FINISHED_CHECK_EVERY == 0 and bool(finished.all()):
            break
        filtered = logits + suppress_mask
        if step == 0:
            filtered = filtered + blank_mask
        if temperature == 0.0:
            next_tok = filtered.argmax(dim=-1)
        else:
            probs = torch.softmax(filtered / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        logprobs = torch.log_softmax(filtered, dim=-1)
        tok_logprob = logprobs.gather(-1, next_tok[:, None])[:, 0]

        next_tok = torch.where(finished, eot, next_tok)
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, tok_logprob)
        finished = finished | (next_tok == eot)

        pos = n_prefix + step
        tokens[:, pos] = next_tok
        if step + 1 < sample_len:  # the last token's logits are never read
            step_logits, cache = decode_step(
                params, cfg, next_tok[:, None], cache, pos, dtype=dtype
            )
            logits = step_logits[:, 0]
    return tokens, sum_logprobs, sot_logits


# -- public API -----------------------------------------------------------

def _check_supported(options: DecodingOptions, cfg: WhisperConfig) -> None:
    missing = []
    if options.beam_size is not None:
        missing.append("beam_size")
    if options.best_of is not None and options.best_of > 1:
        missing.append("best_of > 1")
    if options.kv_int4:
        missing.append("kv_int4")
    if options.language is None and cfg.multilingual:
        missing.append("language=None (language detection)")
    if not options.without_timestamps:
        missing.append("timestamp rules (without_timestamps=False)")
    if missing:
        raise NotImplementedError(
            "not ported to the PyTorch package yet: " + ", ".join(missing)
        )


def _device_of(params) -> torch.device:
    return params["decoder"]["token_embedding"].device


def decode(
    params,
    cfg: WhisperConfig,
    audio_input,
    options: DecodingOptions = DecodingOptions(),
    tokenizer: Optional[WhisperTokenizer] = None,
) -> List[DecodingResult]:
    """Decode log-mel spectrograms or encoder output to text.

    audio_input: (B, 2 * n_audio_ctx, n_mels) mel or (B, n_audio_ctx, d)
    encoder output, a tensor or array; it is moved to the parameters'
    device. Returns one DecodingResult per batch element.
    """
    _check_supported(options, cfg)
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=options.language or "en",
            task=options.task,
        )
    elif options.language and tokenizer.language != options.language:
        tokenizer = replace(tokenizer)
        tokenizer.language = options.language

    dtype = torch.bfloat16 if options.fp16 else torch.float32
    device = _device_of(params)

    with torch.inference_mode(), full_fp32():
        audio_input = torch.as_tensor(audio_input).to(device)
        if audio_input.dim() == 2:
            audio_input = audio_input[None]
        if audio_input.shape[-1] == cfg.n_mels:
            audio_features = encode(params, cfg, audio_input, dtype=dtype)
        else:
            audio_features = audio_input

        prefix = initial_tokens(tokenizer, options)
        n_prefix = len(prefix)
        sot_index = prefix.index(tokenizer.sot)
        B = audio_features.shape[0]
        prefix_tokens = torch.tensor(prefix, device=device)[None].repeat(B, 1)

        sample_len = options.sample_len or (cfg.n_text_ctx // 2)
        sample_len = min(sample_len, cfg.n_text_ctx - n_prefix)

        suppress_mask = torch.from_numpy(
            build_suppress_mask(tokenizer, options, cfg.n_vocab)
        ).to(device)
        blank_mask = (
            torch.from_numpy(build_blank_mask(tokenizer, cfg.n_vocab))
            if options.suppress_blank
            else torch.zeros(cfg.n_vocab)
        ).to(device)
        generator = None
        if options.temperature > 0.0:
            generator = torch.Generator(device=device).manual_seed(options.seed)

        tokens, sum_logprobs, sot_logits = _greedy_decode(
            params, cfg, audio_features, prefix_tokens, suppress_mask,
            blank_mask, tokenizer.eot, int(sample_len),
            float(options.temperature), generator, dtype, sot_index,
            options.kv_int8,
        )
        no_speech_probs = torch.softmax(sot_logits, dim=-1)[:, tokenizer.no_speech]
        tokens_np = tokens.cpu().numpy()
        sum_logprobs_np = sum_logprobs.cpu().numpy()
        no_speech_np = no_speech_probs.float().cpu().numpy()

    results = []
    for b in range(B):
        seq = tokens_np[b, n_prefix:]
        eot_pos = np.nonzero(seq == tokenizer.eot)[0]
        end = int(eot_pos[0]) if len(eot_pos) else len(seq)
        out_tokens = seq[:end].tolist()
        text = tokenizer.decode_text(out_tokens).strip()
        results.append(
            DecodingResult(
                tokens=out_tokens,
                text=text,
                # averaged over the emitted tokens and the EOT decision
                avg_logprob=float(sum_logprobs_np[b]) / (end + 1),
                no_speech_prob=float(no_speech_np[b]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
                language=options.language or tokenizer.language,
            )
        )
    return results
