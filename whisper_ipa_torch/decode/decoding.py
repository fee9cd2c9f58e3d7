"""Autoregressive decoding: options, logit masks, the greedy/sampling loop.

Counterpart of ``whisper_ipa_tpu/decode/decoding.py``. The reference runs
the token loop as one ``lax.while_loop``; here it is a Python loop over
one iteration function (the masks, the choice, ``decode_step``) with the
same state (token buffer, finished mask, summed log-probabilities) and
the same masking rules. On CUDA it replays that iteration as a CUDA graph
in every step but the first and the last, so a step costs the host one
launch instead of one per kernel (``_greedy_decode``). It asks the device
whether every row has finished only every ``FINISHED_CHECK_EVERY`` tokens,
not every token: steps past the end write EOT over EOT and add nothing to
the scores, so the result is the same as stopping at once.

``language=None`` on a multilingual model identifies each row's language
from one decoder step on SOT (``detect_language``) and patches it into the
prefix, as the reference does.

The cross cache is float, int8 (``kv_int8``) or nibble-packed int4
(``kv_int4``, which wins over ``kv_int8`` as in the reference).

With ``without_timestamps=False`` (the default, as in the reference) the
loop applies Whisper's timestamp grammar (``apply_timestamp_rules``) after
the suppress and blank masks. At temperature > 0, ``best_of=N`` samples N
candidates for each input and keeps the best by ``sequence_score``
(``rank_candidates``); ``beam_size`` hands the batch to ``beam.py``.

The loop takes a model's cache build, prefix and single-token step
(``DecodeSteps``): Whisper's by default, and an audio language model's
(``models.audio_llm``, an ``AudioLLMConfig``) when ``decode`` is given
one; both share the masks, the finished check, ``DecodingResult`` and
the graph path.

Each call is the span ``decode`` (``utils.timing``), and the greedy loop's
parts its children: ``decode.cast``, ``decode.init_cache`` (an audio
language model's ``llm.init_cache``),
``decode.prefix``, ``decode.capture`` on the graph path, one
``decode.step`` an iteration (with ``decode.finished_check`` inside it
where the host reads the finished mask, and ``decode.replay`` where it
replays the graph) and ``decode.readback``. They record only under a
profiler or ``timing.tracing()``.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, replace
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import AudioLLMConfig, WhisperConfig
from ..models import audio_llm
from ..models.whisper import cast_decoder_blocks, decode_step, encode, init_cache
from ..ops.decode_attention import (
    decode_cross_attention_int4_tminor,
    decode_cross_attention_int8_tminor,
)
from ..ops.precision import full_fp32
from ..ops.quant_matmul import int4_matmul, int8_matmul
from ..tokenizer import LANGUAGES, LANGUAGES_V3, WhisperTokenizer, get_tokenizer
from ..tokenizer.whisper_tokenizer import N_TIMESTAMPS
from ..utils import timing

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
    # an audio language model's row: the slots each position was routed
    # to in each layer, (L, T, top_k) int8 on the device (models.audio_llm)
    routes: Optional[torch.Tensor] = None


def detect_language(
    params,
    cfg: WhisperConfig,
    audio_features,
    tokenizer: Optional[WhisperTokenizer] = None,
    tp=None,
):
    """Identify the spoken language from encoder output.

    Returns (language codes, [{code: probability}] per row): one float32
    decoder step on SOT, softmax over the language-token block.
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual, num_languages=cfg.num_languages
        )
    device = _device_of(params)
    with torch.inference_mode(), full_fp32():
        feats = torch.as_tensor(audio_features).to(device)
        cache = init_cache(params, cfg, feats, max_len=8, tp=tp)
        sot = torch.full(
            (feats.shape[0], 1), tokenizer.sot, dtype=torch.long, device=device
        )
        logits, _ = decode_step(params, cfg, sot, cache, 0, tp=tp)
        logits = logits[:, 0].float().cpu().numpy()
    lang_logits = logits[:, np.asarray(tokenizer.all_language_tokens)]
    probs = np.exp(lang_logits - lang_logits.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)
    langs = (
        LANGUAGES_V3 if tokenizer.num_languages == 100 else LANGUAGES
    )[: tokenizer.num_languages]
    codes = [langs[i] for i in probs.argmax(axis=-1)]
    return codes, [dict(zip(langs, row.tolist())) for row in probs]


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


def rank_candidates(
    tokens: np.ndarray,
    sum_logprobs: np.ndarray,
    n_candidates: int,
    n_prefix: int,
    eot: int,
    length_penalty: Optional[float],
) -> List[int]:
    """Best-of-N: for each input, the row of its highest-scoring candidate.

    tokens: (B * n_candidates, n_prefix + sample_len), the candidates of
    input b in rows b * n_candidates ... (b + 1) * n_candidates - 1;
    sum_logprobs: (B * n_candidates,). A candidate's length runs to its
    first EOT; the first best wins a tie, as in the reference.
    """
    keep = []
    for b in range(tokens.shape[0] // n_candidates):
        best_row, best_score = b * n_candidates, -np.inf
        for row in range(b * n_candidates, (b + 1) * n_candidates):
            seq = tokens[row, n_prefix:]
            eot_pos = np.nonzero(seq == eot)[0]
            end = int(eot_pos[0]) if len(eot_pos) else len(seq)
            score = sequence_score(float(sum_logprobs[row]), end, length_penalty)
            if score > best_score:
                best_row, best_score = row, score
        keep.append(best_row)
    return keep


# -- timestamp grammar (shared by the greedy and beam loops) --------------

def apply_timestamp_rules(
    logits: torch.Tensor,
    vocab_idx: torch.Tensor,
    step: int,
    prev_tok: torch.Tensor,
    prev2_tok: torch.Tensor,
    last_ts: torch.Tensor,
    *,
    eot: int,
    timestamp_begin: int,
    max_initial_ts_index: int,
) -> torch.Tensor:
    """Whisper's ApplyTimestampRules, batched over any leading dims.

    ``logits``: (..., V); ``prev_tok``/``prev2_tok``/``last_ts``: (...,);
    ``step``: the sampled position (0 = the first). The reference's rules:

    - timestamps come in pairs (except directly before EOT): after a lone
      timestamp only timestamps or EOT may follow; after a pair only text
    - timestamps are strictly increasing, except that the token closing a
      lone (segment-opening) timestamp may equal it
    - the first sampled token is a timestamp, at most max_initial_ts_index
    - when the total timestamp probability beats every text token, a
      timestamp must be sampled

    ``last_ts`` starts at ``timestamp_begin - 1``: no timestamp emitted
    yet, so no monotonicity constraint applies.
    """
    neg_inf = float("-inf")
    is_ts = vocab_idx >= timestamp_begin  # (V,)
    last_was_ts = prev_tok >= timestamp_begin
    pen_was_ts = prev2_tok >= timestamp_begin
    lone = last_was_ts & ~pen_was_ts

    suppress_ts = (last_was_ts & pen_was_ts)[..., None] & is_ts
    force_ts = lone[..., None] & ~(is_ts | (vocab_idx == eot))
    logits = logits.masked_fill(suppress_ts | force_ts, neg_inf)

    min_allowed = torch.where(lone, last_ts, last_ts + 1)
    logits = logits.masked_fill(
        is_ts & (vocab_idx < min_allowed[..., None]), neg_inf
    )

    if step == 0:
        first_allowed = is_ts & (vocab_idx <= timestamp_begin + max_initial_ts_index)
        logits = logits.masked_fill(~first_allowed, neg_inf)

    lp = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(lp.masked_fill(~is_ts, neg_inf), dim=-1)
    max_text = lp.masked_fill(is_ts, neg_inf).amax(dim=-1)
    dominate = (ts_mass > max_text)[..., None]
    return logits.masked_fill(dominate & ~is_ts, neg_inf)


# -- greedy / sampling loop -----------------------------------------------

class _LoopState(NamedTuple):
    """The loop's state between iterations, all on the device: the logits
    the next token is chosen from (B, n_vocab), the finished mask, the
    summed log-probabilities, the last two tokens and the last timestamp
    (the grammar's state) and the position of the next token (0-d)."""

    logits: torch.Tensor
    finished: torch.Tensor
    sum_logprobs: torch.Tensor
    prev_tok: torch.Tensor
    prev2_tok: torch.Tensor
    last_ts: torch.Tensor
    pos: torch.Tensor


# The kernel wrappers a decode step may launch. Each counts its launches
# in ``.launches``; a graph replay runs no Python, so it adds the count its
# capture made, and a decode counts what it would have counted eagerly.
_COUNTED_KERNELS = (
    decode_cross_attention_int8_tminor,
    decode_cross_attention_int4_tminor,
    int8_matmul,
    int4_matmul,
)

# This thread's side stream and last captured graph, by CUDA device. A
# capture shares the last graph's memory pool, which that graph, never
# replayed again, no longer needs, so successive decodes reuse one pool
# instead of leaving one behind each; threads do not share a pool, so
# their graphs never replay over each other's memory.
_GRAPHS = threading.local()


def _graph_path(device: torch.device, tp, generator) -> bool:
    """Whether the loop replays its steps as one CUDA graph: on CUDA,
    without a tensor-parallel group (its collectives cannot be captured
    over gloo) and without a sampling generator (a replay would not
    advance it)."""
    return device.type == "cuda" and tp is None and generator is None


def _capture_step(iteration, state: _LoopState, step: int):
    """Capture ``iteration(state, step, True)`` as a CUDA graph whose
    inputs are also its outputs: returns (graph, static state, launches),
    the static state holding ``state``'s values until the first replay,
    each replay advancing it by one iteration in place, and ``launches``
    the ``.launches`` each of ``_COUNTED_KERNELS`` gains a replay.

    The capture runs on the thread's side stream. The first capture on
    that stream runs one warm-up iteration there before it, on a scratch
    copy of the state: it sets up what the stream needs outside a capture
    (cuBLAS's workspace for the stream), which later captures find in
    place; the step's own kernels have run eagerly at step 0 already.
    The warm-up writes its token and its K/V at the step's own position,
    which the step's replay writes again, and adds nothing to the launch
    counters or to the program's counters (``timing.paused``): a decode
    counts what the eager loop counts."""
    device = state.logits.device
    slots = _GRAPHS.__dict__.setdefault("by_device", {})
    side, last = slots.get(device.index, (None, None))
    main = torch.cuda.current_stream(device)
    before = [fn.launches for fn in _COUNTED_KERNELS]
    static = _LoopState(*(t.clone() for t in state))
    if side is None:
        side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        if last is None:
            with timing.paused():
                iteration(_LoopState(*(t.clone() for t in state)), step, True)
        warm = [fn.launches for fn in _COUNTED_KERNELS]
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=last.pool() if last is not None else None,
                            capture_error_mode="thread_local")
        try:
            out = iteration(static, step, True)
            # an output that is an input (the last token becomes the one
            # before it) is copied before any input is overwritten
            out = [o.clone() if any(o is t for t in static) else o for o in out]
            for t, o in zip(static, out):
                t.copy_(o)
        finally:
            graph.capture_end()
    main.wait_stream(side)
    launches = [fn.launches - w for fn, w in zip(_COUNTED_KERNELS, warm)]
    for fn, n in zip(_COUNTED_KERNELS, before):
        fn.launches = n
    slots[device.index] = (side, graph)
    return graph, static, launches


class DecodeSteps(NamedTuple):
    """A model's three parts of the greedy loop: ``init_cache(max_len)``
    builds the cache for ``max_len`` positions; ``prefix(cache)`` runs the
    prefix and returns (logits (B, P, n_vocab) float32, of which the loop
    reads the last position and ``sot_index``, and the cache);
    ``step(tokens (B, 1), cache, pos)`` runs one token a row at the 0-d
    device position ``pos`` and returns logits (B, 1, n_vocab) float32,
    reading nothing on the host (the graph path replays it)."""

    init_cache: Callable[[int], Any]
    prefix: Callable[[Any], Any]
    step: Callable[[torch.Tensor, Any, torch.Tensor], torch.Tensor]


def _whisper_steps(params, cfg: WhisperConfig, audio_features, prefix_tokens,
                   dtype, cross_kv_int8: bool, cross_kv_int4: bool, tp):
    """Whisper's parts: the decoder cast once (``decode.cast``), the cross
    cache (``decode.init_cache``), ``decode_step`` on the prefix and on
    each token."""
    # one cast before the loop, as the reference does outside its loop
    with timing.span("decode.cast"):
        params = cast_decoder_blocks(params, dtype)

    def build(max_len):
        with timing.span("decode.init_cache"):
            return init_cache(
                params, cfg, audio_features, max_len=max_len, dtype=dtype,
                cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4, tp=tp,
            )

    def prefix(cache):
        return decode_step(params, cfg, prefix_tokens, cache, 0, dtype=dtype, tp=tp)

    def step(tokens, cache, pos):
        return decode_step(params, cfg, tokens, cache, pos, dtype=dtype, tp=tp)[0]

    return DecodeSteps(build, prefix, step)


def _audio_llm_steps(params, cfg: AudioLLMConfig, features, prompt_ids,
                     audio_start: int, dtype, built: list):
    """An audio language model's parts (``models.audio_llm``): the K/V
    cache (``llm.init_cache``; appended to ``built``, for the caller to
    read the routes and the routing counter after the loop), the prefill
    of the prompt with its audio, and the single-token step."""

    def build(max_len):
        with timing.span("llm.init_cache"):
            cache = audio_llm.init_cache(cfg, prompt_ids.shape[0], max_len, dtype,
                                         prompt_ids.device)
        built.append(cache)
        return cache

    def prefix(cache):
        return audio_llm.prefill(params, cfg, prompt_ids, audio_start, features,
                                 cache, dtype), cache

    def step(tokens, cache, pos):
        return audio_llm.decode_step(params, cfg, tokens, cache, pos, dtype)

    return DecodeSteps(build, prefix, step)


def _greedy_decode(
    steps: DecodeSteps,
    prefix_tokens: torch.Tensor,  # (B, n_prefix) int64
    suppress_mask: torch.Tensor,  # (n_vocab,) f32
    blank_mask: torch.Tensor,  # (n_vocab,) f32
    eot: int,
    sample_len: int,
    temperature: float,
    generator: Optional[torch.Generator],
    sot_index: int,
    *,
    timestamp_rules: bool,
    timestamp_begin: int,
    max_initial_ts_index: int,
    tp=None,
):
    """Batched greedy/temperature decode; returns (tokens (B, n_prefix +
    sample_len), sum_logprobs (B,), sot_logits (B, n_vocab)).

    ``steps`` are the model's cache build, prefix and single-token step
    (``DecodeSteps``: ``_whisper_steps`` or ``_audio_llm_steps``); the
    loop itself names no model. ``tp`` only keeps it off the graph path.

    With ``timestamp_rules`` the grammar state follows the reference's
    loop: the last two tokens start at the prefix's last two, the last
    timestamp at ``timestamp_begin - 1``, and it moves only on a
    timestamp token.

    One iteration is one function (``iteration``) over the loop's state;
    the position is a device value, so the iteration reads nothing from
    the host. On the graph path (``_graph_path``) step 0 (the blank mask,
    the timestamp grammar's first window) runs eagerly, step 1's
    iteration is captured as a CUDA graph (the span ``decode.capture``)
    and replayed for steps 1 to ``sample_len`` - 2 (``decode.replay``),
    and the last iteration, which runs no forward, is eager again: the
    same kernels on the same data as the eager loop, launched by one
    call a step. The finished check stays on the host between steps."""
    B, n_prefix = prefix_tokens.shape
    max_len = n_prefix + sample_len
    cache = steps.init_cache(max_len)
    with timing.span("decode.prefix"):
        prefix_logits, cache = steps.prefix(cache)
        sot_logits = prefix_logits[:, sot_index]

        device = prefix_tokens.device
        tokens = torch.full((B, max_len), eot, dtype=torch.long, device=device)
        tokens[:, :n_prefix] = prefix_tokens
        vocab_idx = torch.arange(suppress_mask.shape[0], device=device)
        state = _LoopState(
            logits=prefix_logits[:, -1],
            finished=torch.zeros(B, dtype=torch.bool, device=device),
            sum_logprobs=torch.zeros(B, dtype=torch.float32, device=device),
            prev_tok=prefix_tokens[:, -1],
            prev2_tok=prefix_tokens[:, -2] if n_prefix >= 2 else prefix_tokens[:, -1],
            last_ts=torch.full((B,), timestamp_begin - 1, dtype=torch.long,
                               device=device),
            pos=torch.full((), n_prefix, dtype=torch.long, device=device),
        )

    def iteration(st: _LoopState, step: int, forward: bool) -> _LoopState:
        """Choose the token at ``st.pos`` (``step`` counts from the first
        sampled position) and write it; with ``forward`` run it through
        the decoder for the next logits."""
        filtered = st.logits + suppress_mask
        if step == 0:
            filtered = filtered + blank_mask
        if timestamp_rules:
            filtered = apply_timestamp_rules(
                filtered, vocab_idx, step, st.prev_tok, st.prev2_tok, st.last_ts,
                eot=eot, timestamp_begin=timestamp_begin,
                max_initial_ts_index=max_initial_ts_index,
            )
        if temperature == 0.0:
            next_tok = filtered.argmax(dim=-1)
        else:
            probs = torch.softmax(filtered / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        logprobs = torch.log_softmax(filtered, dim=-1)
        tok_logprob = logprobs.gather(-1, next_tok[:, None])[:, 0]

        next_tok = torch.where(st.finished, eot, next_tok)
        sum_logprobs = st.sum_logprobs + torch.where(st.finished, 0.0, tok_logprob)
        finished = st.finished | (next_tok == eot)
        last_ts = torch.where(next_tok >= timestamp_begin, next_tok, st.last_ts)

        tokens.index_copy_(1, st.pos.view(1), next_tok[:, None])
        logits = st.logits
        if forward:  # the last token's logits are never read
            logits = steps.step(next_tok[:, None], cache, st.pos)[:, 0]
        return _LoopState(logits, finished, sum_logprobs, next_tok, st.prev_tok,
                          last_ts, st.pos + 1)

    use_graph = _graph_path(device, tp, generator)
    graph = None
    for step in range(sample_len):
        forward = step + 1 < sample_len
        if use_graph and step == 1 and forward:
            with timing.span("decode.capture"):
                graph, state, launches = _capture_step(iteration, state, step)
        with timing.span("decode.step"):
            if step and step % FINISHED_CHECK_EVERY == 0:
                with timing.span("decode.finished_check"):
                    done = bool(state.finished.all())
                if done:
                    break
            if graph is not None and forward:
                with timing.span("decode.replay"):
                    graph.replay()
                for fn, n in zip(_COUNTED_KERNELS, launches):
                    fn.launches += n
            else:
                state = iteration(state, step, forward)
    return tokens, state.sum_logprobs, sot_logits


# -- public API -----------------------------------------------------------

def _device_of(params) -> torch.device:
    return params["decoder"]["token_embedding"].device


def decode(
    params,
    cfg: WhisperConfig,
    audio_input,
    options: DecodingOptions = DecodingOptions(),
    tokenizer: Optional[WhisperTokenizer] = None,
    *,
    tp=None,
) -> List[DecodingResult]:
    """Decode log-mel spectrograms or encoder output to text.

    audio_input: (B, 2 * n_audio_ctx, n_mels) mel or (B, n_audio_ctx, d)
    encoder output, a tensor or array; it is moved to the parameters'
    device. Returns one DecodingResult per batch element.

    tp: the tensor-parallel group (``mesh.tp``) when ``params`` are the
    rank's Megatron blocks (``parallel.shard_params``); every rank of the
    group runs the same call on the same rows and gets the same tokens.
    The reference reads the sharding from its arrays; here it is named.
    """
    with timing.span("decode"):
        if isinstance(cfg, AudioLLMConfig):
            return _decode_audio_llm(params, cfg, audio_input, options)
        return _decode(params, cfg, audio_input, options, tokenizer, tp)


def _prompt_ids(ids, what: str) -> List[int]:
    if ids is None:
        return []
    if isinstance(ids, str):
        raise ValueError(f"an audio language model takes its {what} as token ids")
    return [int(t) for t in ids]


def audio_llm_suppress_mask(cfg: AudioLLMConfig, options: DecodingOptions) -> np.ndarray:
    """Additive mask (n_vocab,): -inf at ``options.suppress_tokens``' ids;
    "-1" (alone or among the ids) stands for every special id but the end
    of turn."""
    opt = options.suppress_tokens
    ids = [-1] if opt == "-1" else [] if isinstance(opt, str) or not opt else [
        int(t) for t in opt]
    suppress = {t for t in ids if t >= 0}
    if -1 in ids:
        suppress.update(t for t in range(cfg.first_special, cfg.n_vocab) if t != cfg.eos)
    mask = np.zeros((cfg.n_vocab,), dtype=np.float32)
    mask[sorted(t for t in suppress if t < cfg.n_vocab)] = -np.inf
    return mask


def _decode_audio_llm(params, cfg: AudioLLMConfig, audio_input,
                      options: DecodingOptions) -> List[DecodingResult]:
    """``decode`` for an audio language model (``models.audio_llm``): the
    tower over a log-mel (or its frames as given), the prompt
    [``options.prompt`` ids; the audio; ``options.prefix`` ids], then the
    same greedy loop as Whisper's (``_greedy_decode``) until the end of
    turn (``cfg.eos``) or ``sample_len`` tokens. Results carry no text (no
    tokenizer) and each row's ``routes``; ``no_speech_prob`` is NaN. Beam
    search and best-of are Whisper's only."""
    if options.beam_size is not None or (options.best_of and options.temperature > 0):
        raise ValueError("an audio language model decodes greedily or by sampling")
    dtype = torch.bfloat16 if options.fp16 else torch.float32
    device = params["embed"].device
    pre = _prompt_ids(options.prompt, "prompt")
    post = _prompt_ids(options.prefix, "prefix")
    with torch.inference_mode(), full_fp32():
        x = torch.as_tensor(audio_input).to(device)
        if x.dim() == 2:
            x = x[None]
        if x.shape[-1] == cfg.n_mels:
            features = audio_llm.encode_audio(params, cfg, x, dtype)
        else:
            features = x
        B = features.shape[0]
        prompt = pre + [-1] * cfg.n_audio_tokens + post
        prompt_ids = torch.tensor(prompt, device=device)[None].repeat(B, 1)
        sample_len = int(options.sample_len or 224)
        suppress_mask = torch.from_numpy(audio_llm_suppress_mask(cfg, options)).to(device)
        blank_mask = torch.zeros(cfg.n_vocab, device=device)
        generator = None
        if options.temperature > 0.0:
            generator = torch.Generator(device=device).manual_seed(options.seed)
        built = []
        steps = _audio_llm_steps(params, cfg, features, prompt_ids, len(pre), dtype,
                                 built)
        tokens, sum_logprobs, _ = _greedy_decode(
            steps, prompt_ids, suppress_mask, blank_mask, cfg.eos, sample_len,
            float(options.temperature), generator, 0, timestamp_rules=False,
            timestamp_begin=cfg.n_vocab, max_initial_ts_index=0,
        )
    cache = built[0]
    with timing.span("decode.readback"):
        audio_llm.record_routing(cache)
        tokens_np = tokens.cpu().numpy()
        sum_logprobs_np = sum_logprobs.cpu().numpy()
    n_prefix = len(prompt)
    results = []
    for b in range(B):
        seq = tokens_np[b, n_prefix:]
        eos = np.nonzero(seq == cfg.eos)[0]
        end = int(eos[0]) if len(eos) else len(seq)
        results.append(DecodingResult(
            tokens=seq[:end].tolist(), text="",
            avg_logprob=float(sum_logprobs_np[b]) / (end + 1),
            no_speech_prob=float("nan"), temperature=options.temperature,
            compression_ratio=0.0, routes=cache.routes[:, b]))
    return results


def _decode(params, cfg, audio_input, options, tokenizer, tp):
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
            audio_features = encode(params, cfg, audio_input, dtype=dtype,
                                    tp=tp)
        else:
            audio_features = audio_input

        prefix = initial_tokens(tokenizer, options)
        n_prefix = len(prefix)
        sot_index = prefix.index(tokenizer.sot)
        B = audio_features.shape[0]
        prefix_tokens = torch.tensor(prefix, device=device)[None].repeat(B, 1)
        detected_langs = None
        if options.language is None and cfg.multilingual:
            detected_langs, _ = detect_language(
                params, cfg, audio_features, tokenizer, tp=tp
            )
            prefix_tokens[:, 1] = torch.tensor(
                [tokenizer.language_token(c) for c in detected_langs],
                device=device,
            )

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
        max_initial_ts_index = (
            int(options.max_initial_timestamp / 0.02)
            if options.max_initial_timestamp is not None
            else N_TIMESTAMPS - 1
        )

        if options.beam_size is not None:
            from .beam import beam_decode

            return beam_decode(
                params, cfg, audio_features, prefix, options, tokenizer,
                suppress_mask, blank_mask, prefix_tokens=prefix_tokens,
                sot_index=sot_index, max_initial_ts_index=max_initial_ts_index,
                detected_langs=detected_langs, tp=tp,
            )

        # best_of: at temperature > 0, n candidates an input, tiled in the
        # order of the reference's jnp.repeat, the best of each kept
        n_candidates = (
            int(options.best_of)
            if options.best_of and options.temperature > 0
            else 1
        )
        if n_candidates > 1:
            audio_features = audio_features.repeat_interleave(n_candidates, 0)
            prefix_tokens = prefix_tokens.repeat_interleave(n_candidates, 0)

        generator = None
        if options.temperature > 0.0:
            generator = torch.Generator(device=device).manual_seed(options.seed)

        steps = _whisper_steps(params, cfg, audio_features, prefix_tokens, dtype,
                               options.kv_int8, options.kv_int4, tp)
        tokens, sum_logprobs, sot_logits = _greedy_decode(
            steps, prefix_tokens, suppress_mask, blank_mask, tokenizer.eot,
            int(sample_len), float(options.temperature), generator, sot_index,
            timestamp_rules=not options.without_timestamps,
            timestamp_begin=tokenizer.timestamp_begin,
            max_initial_ts_index=max_initial_ts_index,
            tp=tp,
        )
    with timing.span("decode.readback"):
        with torch.inference_mode(), full_fp32():
            no_speech_probs = torch.softmax(sot_logits, dim=-1)[:, tokenizer.no_speech]
            tokens_np = tokens.cpu().numpy()
            sum_logprobs_np = sum_logprobs.cpu().numpy()
            no_speech_np = no_speech_probs.float().cpu().numpy()

        if n_candidates > 1:
            keep = rank_candidates(tokens_np, sum_logprobs_np, n_candidates,
                                   n_prefix, tokenizer.eot, options.length_penalty)
            tokens_np = tokens_np[keep]
            sum_logprobs_np = sum_logprobs_np[keep]
            no_speech_np = no_speech_np[keep]

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
                    language=(
                        detected_langs[b] if detected_langs
                        else options.language or tokenizer.language
                    ),
                )
            )
    return results
