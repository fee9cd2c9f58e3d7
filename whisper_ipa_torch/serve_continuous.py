"""Continuous (in-flight) batching: requests join a RUNNING decode batch.

Counterpart of ``whisper_ipa_tpu/serve_continuous.py`` (its greedy
engine). The micro-batching service (``serve.py``) coalesces requests into
fixed batches; this engine keeps one persistent decode state of ``slots``
sequences on the device and lets new requests claim finished or empty
slots between chunks of steps (Orca-style in-flight batching):

- every slot has its own length, so steps run through
  ``models.whisper.decode_step_multipos`` (per-element positions, causal
  masks and K/V writes);
- a join feeds the new slot's SOT prefix at position 0 while every other
  slot re-feeds its latest n_prefix tokens in place (an identical-K/V
  rewrite, as in the reference); stale rows of a reclaimed slot are never
  read, because each slot's mask hides rows past its frontier and writes
  land before reads;
- each joining window's log-mel (K1 on CUDA), encoder forward (K2 in
  bf16) and cross K/V are computed on the device and copied into the
  persistent cache's slot in place (the reference donates the buffer);
- steps run in chunks of ``steps_per_sync`` between host syncs: the sync
  reads the emitted tokens to detect EOT and admit joiners, and doubles as
  per-token streaming (``on_token``).

The device functions are plain functions on tensors, run eagerly. The
reference's chunk is a ``while_loop`` that stops on the device once every
slot has halted; reading that condition here costs a host sync, so
``_decode_chunk`` asks only before every ``HALTED_CHECK_EVERY``-th step
(never before the first). Halted slots emit -1 and keep their state
whatever the cadence, so the tokens are the same; the cadence only decides
how many frozen steps a drained batch pays for.

With ``draft_k > 0`` the engine speculates in flight, token-identical to
the greedy engine: a chunk runs ``steps_per_sync`` verification rounds,
each one (K+1)-query forward of the target over K drafts per slot from
prompt lookup over the slot's tokens (``_spec_chunk``), a persistent draft
model with its own slot-aligned cache (``_spec_chunk_model``), Medusa heads
on the frontier hidden state (``_spec_chunk_medusa``) or a Medusa tree
(``_spec_chunk_medusa_tree``). These chunks run their rounds as the
reference's fixed ``lax.scan`` does, with no all-halted check, so
``spec_rounds`` counts the rounds asked for, as the reference's.

Not ported (the constructor raises ``NotImplementedError`` naming the
ROADMAP item): slot or tensor sharding over a mesh (item [18]). The
reference's executable cache (``aot_call``) has no counterpart (item
[14]).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .audio import N_SAMPLES, load_audio, pad_or_trim
from .config import WhisperConfig
from .decode.decoding import (
    DecodingOptions,
    build_blank_mask,
    build_suppress_mask,
    initial_tokens,
)
from .decode.medusa_tree import _tree_tables, tree_round
from .decode.speculative import _accept, _ngram_drafts
from .models.convert import params_to
from .models.medusa import medusa_propose
from .models.whisper import (
    DecoderCache,
    cast_decoder_blocks,
    decode_step_block,
    decode_step_multipos,
    decode_step_multipos_hidden,
    encode,
    init_cache,
)
from .ops.mel_kernel import log_mel_spectrogram
from .tokenizer import WhisperTokenizer, get_tokenizer
from .train.loop import resolve_device

# steps between the chunk's all-halted checks (each one a host sync); a
# default chunk of 4 steps never asks, an adaptive chunk of 16 asks 3 times
HALTED_CHECK_EVERY = 4


# -- device functions -----------------------------------------------------

def _encode_one(params, cfg: WhisperConfig, mel, dtype=torch.float32):
    return encode(params, cfg, mel, dtype=dtype)


def _cross_kv_one(params, cfg: WhisperConfig, features, n_ctx: int = 8,
                  dtype=torch.float32, cross_kv_int8: bool = False):
    """Cross K/V (+ empty self buffers) for one utterance's features."""
    return init_cache(params, cfg, features, max_len=n_ctx, dtype=dtype,
                      cross_kv_int8=cross_kv_int8)


def _scatter_slot(cache: DecoderCache, one: DecoderCache, slot: int):
    """Install one request's cross K/V into batch slot ``slot``, in place."""
    for big, small in ((cache.cross_k, one.cross_k),
                       (cache.cross_v, one.cross_v),
                       (cache.cross_k_scale, one.cross_k_scale),
                       (cache.cross_v_scale, one.cross_v_scale)):
        if big is not None:
            big[:, slot].copy_(small[:, 0])
    return cache


def _join_step(params, cfg: WhisperConfig, cache: DecoderCache, tokens, pos,
               dtype=torch.float32):
    """Consume the SOT prefix for joining slots; re-feed everyone else.

    tokens (B, n_prefix): joiners get their prefix, others their last
    n_prefix tokens; pos (B,): 0 for joiners, lens - n_prefix otherwise."""
    _, cache = decode_step_multipos(params, cfg, tokens, cache, pos,
                                    dtype=dtype)
    return cache


def _decode_chunk(params, cfg: WhisperConfig, cache: DecoderCache, last_tok,
                  lens, finished, suppress_mask, blank_mask, eot: int,
                  n_steps: int, n_prefix: int, max_new: int,
                  dtype=torch.float32, check_every: int = HALTED_CHECK_EVERY):
    """Advance every slot by up to n_steps tokens (frozen once halted).

    Each step re-feeds the slot's latest token at its frontier and picks
    the next greedily. A slot halts when it has finished (EOT) or spent
    its max_new budget; the budget is enforced here, on the device, so a
    chunk never advances lens past n_prefix + max_new nor writes K/V past
    the cache. Halted slots emit -1 and keep lens, finished and last_tok,
    while their K/V row at lens - 1 is rewritten as the reference's does.
    Before every ``check_every``-th step after the first, the host asks
    whether every slot has halted and stops if so (the tokens are -1
    either way). Returns (cache, last_tok, lens, finished, tokens (n_steps,
    B) long, the number of steps run).
    """
    params = cast_decoder_blocks(params, dtype)
    toks = torch.full((n_steps, last_tok.shape[0]), -1, dtype=torch.long,
                      device=last_tok.device)
    steps_run = 0
    for step in range(n_steps):
        halted = finished | (lens - n_prefix >= max_new)
        if step and step % check_every == 0 and bool(halted.all()):
            break
        steps_run += 1
        logits, cache = decode_step_multipos(
            params, cfg, last_tok[:, None], cache, lens - 1, dtype=dtype
        )
        lg = logits[:, 0] + suppress_mask
        lg = torch.where((lens == n_prefix)[:, None], lg + blank_mask, lg)
        nxt = lg.argmax(dim=-1)
        nxt = torch.where(halted, -1, nxt)
        lens = torch.where(halted, lens, lens + 1)
        finished = halted | (nxt == eot)
        last_tok = torch.where((nxt == eot) | (nxt < 0), last_tok, nxt)
        toks[step] = nxt
    return cache, last_tok, lens, finished, toks, steps_run


# -- speculative device functions (draft_k > 0) ---------------------------

def _join_step_hidden(params, cfg: WhisperConfig, cache: DecoderCache, tokens,
                      pos, dtype=torch.float32):
    """``_join_step`` that also returns each slot's frontier hidden state.

    Medusa heads draft from the final-LN hidden of the input at lens - 2
    (head k on h_t predicts the token at t + k + 2). In the join block that
    input sits at block index n_prefix - 2 for joiners (pos 0, lens becomes
    n_prefix) and for re-feeders (pos = lens - n_prefix) alike."""
    _, cache, hidden = decode_step_multipos_hidden(params, cfg, tokens, cache,
                                                   pos, dtype=dtype)
    return cache, hidden[:, tokens.shape[1] - 2]


def _join_step_tree(params, cfg: WhisperConfig, cache: DecoderCache, tokens,
                    start, lens_eff, dtype=torch.float32):
    """The join of tree-Medusa mode, W = max(n_prefix, tree_K + 2) wide.

    A tree round accepts up to K + 1 tokens whose K/V it never writes (tree
    nodes are read only), so a join re-feeds each slot's last W tokens
    (tokens (B, W), EOT past lens_eff) at start = max(lens_eff - W, 0): it
    writes every such row, and the entries past lens_eff are masked out.
    Returns the cache and each slot's hidden of the input at lens_eff - 2
    (the Medusa draft frontier)."""
    B, W = tokens.shape
    pos = start[:, None] + torch.arange(W, device=tokens.device)[None, :]
    real = pos < lens_eff[:, None]
    mask_new = torch.where(
        real[:, None, :] & (pos[:, None, :] <= pos[:, :, None]),
        torch.zeros((), device=tokens.device),
        torch.full((), float("-inf"), device=tokens.device),
    )  # (B, W, W)
    _, cache, hidden = decode_step_block(params, cfg, tokens, cache, pos,
                                         start, mask_new, write_len=W,
                                         dtype=dtype)
    idx = lens_eff - 2 - start  # block index of the input at lens_eff - 2
    return cache, hidden[torch.arange(B, device=tokens.device), idx]


def _advance(emit, m, last_tok, lens, finished, eot: int, n_prefix: int,
             max_new: int):
    """The engine's accept rule after a verification: the m matched tokens
    and the one after them, cut after an EOT and at the max_new budget, 0
    for a finished slot. The engine's lens counts content tokens (an
    emitted EOT is not one). Returns (emit_w (B, K + 1): the emitted tokens,
    EOT past them; v (B,) their count; vc (B,) the content count; last_tok,
    lens, finished)."""
    v, ate_eot = _accept(emit, m, lens, finished, n_prefix, max_new, eot)
    idx = torch.arange(emit.shape[1], device=emit.device)[None, :]
    emit_w = torch.where(idx < v[:, None], emit, eot)
    vc = v - ate_eot.long()
    last = emit.gather(1, (vc - 1).clamp_min(0)[:, None])[:, 0]
    last_tok = torch.where(vc >= 1, last, last_tok)
    lens = lens + vc
    finished = finished | ate_eot | (lens - n_prefix >= max_new)
    return emit_w, v, vc, last_tok, lens, finished


def _write_rows(tokens_buf, emit_w, lens):
    """tokens_buf[b, lens[b]:lens[b] + K + 1] = emit_w[b], in place."""
    idx = torch.arange(emit_w.shape[1], device=emit_w.device)[None, :]
    tokens_buf.scatter_(1, lens[:, None] + idx, emit_w)


def _chain_round(params, cfg, cache, drafts, last_tok, lens, finished,
                 suppress_mask, blank_mask, eot, n_prefix, max_new, dtype):
    """One chain verification: the (K + 1)-query block [last_tok, drafts]
    at lens - 1, then ``_advance`` on the longest run of drafts that equal
    the greedy choices. Returns (cache, block hidden states, emit_w, v, vc,
    last_tok, lens, finished)."""
    K = drafts.shape[1]
    block = torch.cat([last_tok[:, None], drafts], dim=1)
    logits, cache, hidden = decode_step_multipos_hidden(
        params, cfg, block, cache, lens - 1, dtype=dtype)
    # logits[:, i] predicts the token at lens + i: suppress mask, and the
    # blank mask at the first sampled slot
    idx = torch.arange(K + 1, device=lens.device)
    first = (lens[:, None] + idx[None, :]) == n_prefix
    lg = logits + suppress_mask
    greedy = torch.where(first[..., None], lg + blank_mask, lg).argmax(dim=-1)
    a = torch.cumprod((greedy[:, :K] == drafts).long(), dim=1).sum(dim=1)
    return (cache, hidden) + _advance(greedy, a, last_tok, lens, finished,
                                      eot, n_prefix, max_new)


def _spec_chunk(params, cfg: WhisperConfig, cache: DecoderCache, tokens_buf,
                last_tok, lens, finished, suppress_mask, blank_mask, eot: int,
                n_rounds: int, draft_k: int, n_prefix: int, max_new: int,
                dtype=torch.float32):
    """n_rounds n-gram verification rounds on the device.

    Each round drafts K tokens a slot by prompt lookup over tokens_buf (B,
    buf_len: prefix and emitted tokens, EOT past them, written in place as
    rounds emit; ``_ngram_drafts``), verifies them in one (K + 1)-query
    forward and accepts the longest matching run and the token after it:
    the tokens of single-step greedy decoding. Rejected drafts' K/V is written over by the next round's
    frontier re-feed. Returns (cache, last_tok, lens, finished, emits
    (n_rounds, B, K + 1), vs (n_rounds, B)): round r emits
    emits[r, b, :vs[r, b]], EOT included when hit."""
    params = cast_decoder_blocks(params, dtype)
    emits, vs = [], []
    for _ in range(n_rounds):
        drafts = _ngram_drafts(tokens_buf, lens, draft_k)
        (cache, _, emit_w, v, _, last_tok, new_lens, finished) = _chain_round(
            params, cfg, cache, drafts, last_tok, lens, finished,
            suppress_mask, blank_mask, eot, n_prefix, max_new, dtype)
        _write_rows(tokens_buf, emit_w, lens)
        lens = new_lens
        emits.append(emit_w)
        vs.append(v)
    return cache, last_tok, lens, finished, torch.stack(emits), torch.stack(vs)


def _spec_chunk_model(params, draft_params, cfg: WhisperConfig,
                      draft_cfg: WhisperConfig, cache: DecoderCache,
                      draft_cache: DecoderCache, last_tok, lens, finished,
                      suppress_mask, blank_mask, eot: int, n_rounds: int,
                      draft_k: int, n_prefix: int, max_new: int,
                      dtype=torch.float32):
    """n_rounds draft-model verification rounds on the device.

    Each round runs K single-query steps of the persistent draft model (its
    own slot-aligned cache), masked by suppress and blank as verification
    is, then the target's (K + 1)-query verification. The draft's cache
    needs no repair: the accepted tokens are the drafts whose K/V the draft
    steps wrote, and the correction token's row (lens_new - 1) is written by
    the next round's first draft step. Returns (cache, draft_cache,
    last_tok, lens, finished, emits, vs) as ``_spec_chunk``."""
    params = cast_decoder_blocks(params, dtype)
    draft_params = cast_decoder_blocks(draft_params, dtype)
    emits, vs = [], []
    for _ in range(n_rounds):
        tok, steps = last_tok, []
        for i in range(draft_k):
            logits, draft_cache = decode_step_multipos(
                draft_params, draft_cfg, tok[:, None], draft_cache,
                lens - 1 + i, dtype=dtype)
            lg = logits[:, 0] + suppress_mask
            lg = torch.where((lens + i == n_prefix)[:, None], lg + blank_mask,
                             lg)
            tok = lg.argmax(dim=-1)
            steps.append(tok)
        (cache, _, emit_w, v, _, last_tok, lens, finished) = _chain_round(
            params, cfg, cache, torch.stack(steps, dim=1), last_tok, lens,
            finished, suppress_mask, blank_mask, eot, n_prefix, max_new, dtype)
        emits.append(emit_w)
        vs.append(v)
    return (cache, draft_cache, last_tok, lens, finished, torch.stack(emits),
            torch.stack(vs))


def _spec_chunk_medusa(params, medusa_params, cfg: WhisperConfig,
                       cache: DecoderCache, hidden_frontier, last_tok, lens,
                       finished, suppress_mask, blank_mask, eot: int,
                       n_rounds: int, n_prefix: int, max_new: int,
                       dtype=torch.float32):
    """n_rounds Medusa-chain verification rounds on the device.

    The K heads propose all K drafts at once from each slot's frontier
    hidden state (B, d: the final-LN hidden of the input at lens - 2), so a
    round is one (K + 1)-query target forward, which also gives the next
    frontier: the hidden at block index vc - 1, the input at (new lens) -
    2. Returns (cache, hidden_frontier, last_tok, lens, finished, emits,
    vs) as ``_spec_chunk``."""
    params = cast_decoder_blocks(params, dtype)
    B = last_tok.shape[0]
    rows = torch.arange(B, device=last_tok.device)
    emits, vs = [], []
    for _ in range(n_rounds):
        drafts = medusa_propose(medusa_params, params, hidden_frontier, dtype)
        (cache, hidden, emit_w, v, vc, last_tok, lens,
         finished) = _chain_round(
            params, cfg, cache, drafts, last_tok, lens, finished,
            suppress_mask, blank_mask, eot, n_prefix, max_new, dtype)
        new_hf = hidden[rows, (vc - 1).clamp_min(0)]
        hidden_frontier = torch.where((vc >= 1)[:, None], new_hf,
                                      hidden_frontier)
        emits.append(emit_w)
        vs.append(v)
    return (cache, hidden_frontier, last_tok, lens, finished,
            torch.stack(emits), torch.stack(vs))


def _spec_chunk_medusa_tree(params, medusa_params, cfg: WhisperConfig,
                            cache: DecoderCache, tokens_buf, hidden_frontier,
                            last_tok, lens, finished, suppress_mask,
                            blank_mask, eot: int, n_rounds: int,
                            n_prefix: int, max_new: int, dtype=torch.float32,
                            tree=None):
    """n_rounds tree-Medusa verification rounds on the device.

    Each round is ``medusa_tree.tree_round``: it re-feeds each slot's last
    K + 2 tokens from tokens_buf (as ``_spec_chunk``'s, written in place;
    rows already in the cache are written again from the same tokens, so
    every slot's cache is valid below lens) and verifies the tree's nodes
    in the same forward, accepting along the running greedy token. The
    next frontier hidden is the block entry whose logits gave the last
    content token (``sel``). Returns (cache, hidden_frontier, last_tok,
    lens, finished, emits, vs) as ``_spec_chunk``, K the tree's depth."""
    params = cast_decoder_blocks(params, dtype)
    B = last_tok.shape[0]
    rows = torch.arange(B, device=last_tok.device)
    emits, vs = [], []
    for _ in range(n_rounds):
        cache, emit, _, sel, m, hidden = tree_round(
            params, medusa_params, cfg, cache, tokens_buf, hidden_frontier,
            lens, suppress_mask, blank_mask, n_prefix, tree, dtype)
        emit_w, v, vc, last_tok, new_lens, finished = _advance(
            emit, m, last_tok, lens, finished, eot, n_prefix, max_new)
        _write_rows(tokens_buf, emit_w, lens)
        pick = sel.gather(1, (vc - 1).clamp_min(0)[:, None])[:, 0]
        hidden_frontier = torch.where((vc >= 1)[:, None], hidden[rows, pick],
                                      hidden_frontier)
        lens = new_lens
        emits.append(emit_w)
        vs.append(v)
    return (cache, hidden_frontier, last_tok, lens, finished,
            torch.stack(emits), torch.stack(vs))


# -- engine ---------------------------------------------------------------

@dataclass
class _Slot:
    future: Optional[Future] = None
    tokens: List[int] = field(default_factory=list)  # current window
    window_tokens: List[List[int]] = field(default_factory=list)
    windows: List[np.ndarray] = field(default_factory=list)  # remaining
    truncated: bool = False
    submitted_at: float = 0.0
    started_at: float = 0.0
    first_token_at: float = 0.0  # first token visible on the host (TTFT)
    on_token: Optional[Callable[[dict], None]] = None
    deadline: Optional[float] = None  # absolute wall time; None = no limit
    timed_out: bool = False

    def all_tokens(self) -> List[int]:
        out: List[int] = []
        for w in self.window_tokens:
            out.extend(w)
        out.extend(self.tokens)
        return out


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the waiting queue is at max_pending:
    backpressure for upstream load shedding (the HTTP layer answers 503)."""


class ContinuousBatcher:
    """In-flight batching greedy transcription engine on one device.

    device: where the engine runs ("cuda" by default, "cuda:1", "cpu"); the
    parameters are moved there, and "cuda" without a card raises.
    slots: persistent batch width. max_new_tokens: per-window budget.
    steps_per_sync: decode steps between host syncs (a new request waits
    at most one chunk before joining).
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        *,
        device: Union[str, torch.device] = "cuda",
        slots: int = 8,
        max_new_tokens: int = 128,
        steps_per_sync: int = 4,
        language: str = "en",
        bf16: bool = False,
        kv_int8: bool = False,
        draft_k: int = 0,
        draft_params=None,
        draft_cfg: Optional[WhisperConfig] = None,
        medusa_params=None,
        medusa_tree=None,
        tokenizer: Optional[WhisperTokenizer] = None,
        mesh=None,
        tensor_parallel: bool = False,
        max_pending: Optional[int] = None,
        join_fast_sync: bool = True,
        prewarm: bool = False,
        adaptive_sync: bool = False,
        adaptive_mult: int = 4,
    ):
        """The reference's options, with its meanings:

        draft_k > 0 turns on in-flight speculation: n-gram drafts by
        default, or a persistent draft model when draft_params/draft_cfg
        are given (its own slot-aligned cache, K drafts a round).
        medusa_params: Medusa heads draft in one shot from the frontier
        hidden state; draft_k is taken from the head count. medusa_tree: a
        static (parent, cand) tree (``decode/medusa_tree.py``) verified in
        the same forward; draft_k becomes max(heads, depth + 2), the tree
        round's re-feed. The tokens are the greedy engine's in every mode.
        max_pending: bound on the waiting queue; submit() raises
        EngineOverloaded beyond it. Per-request deadlines and
        cancellation: submit(..., deadline_sec=...) and Future.cancel().
        join_fast_sync: run a 1-round chunk right after a join, so the
        joiner's first token reaches the host after one step instead of
        a full chunk (a TTFT knob; one extra host sync per join event).
        prewarm: build every kernel the path reaches (log-mel, encoder,
        cross cache, join, chunk) in __init__, before the engine thread
        starts, so that no request pays for a build; the engine state
        stays all-empty and the stats start at 0.
        adaptive_sync: when nothing waits to join, run a long chunk of
        steps_per_sync * adaptive_mult rounds (fewer host syncs; a request
        arriving meanwhile waits up to that long to join).
        """
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        if medusa_params is not None and draft_params is not None:
            raise ValueError("medusa_params excludes a draft model")
        if medusa_tree is not None and medusa_params is None:
            raise ValueError("medusa_tree needs medusa_params")
        tree_k = None
        if medusa_params is not None:
            draft_k = len(medusa_params["heads"])
            if medusa_tree is not None:
                tree_k = _tree_tables(medusa_tree)[5]
                if tree_k > draft_k:
                    raise ValueError(
                        f"tree depth {tree_k} exceeds {draft_k} heads")
                draft_k = max(draft_k, tree_k + 2)  # the re-feed's headroom
        if draft_params is not None and draft_k <= 0:
            raise ValueError("a draft model needs draft_k > 0")
        if draft_cfg is not None and (
            draft_cfg.n_vocab != cfg.n_vocab
            or draft_cfg.multilingual != cfg.multilingual
            or draft_cfg.n_mels != cfg.n_mels
        ):
            raise ValueError(
                "draft and target must share tokenizer and mel size")
        unported = {
            "mesh (ROADMAP queue 1 item [18])": mesh is not None,
            "tensor_parallel (ROADMAP queue 1 item [18])": tensor_parallel,
        }
        missing = [name for name, used in unported.items() if used]
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + ", ".join(missing)
            )
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        # decoder blocks cast once to the decode dtype (linear() casts the
        # weights to the activations' dtype either way)
        self.params = cast_decoder_blocks(params_to(params, self.device),
                                          self.dtype)
        self.cfg = cfg
        self.draft_params = (
            None if draft_params is None else
            cast_decoder_blocks(params_to(draft_params, self.device),
                                self.dtype))
        self.draft_cfg = draft_cfg
        self.medusa_params = (None if medusa_params is None
                              else params_to(medusa_params, self.device))
        self.medusa_tree = (tuple(tuple(node) for node in medusa_tree)
                            if medusa_tree else None)
        self.draft_k = draft_k
        self.slots = slots
        self.steps_per_sync = steps_per_sync
        self.adaptive_sync = adaptive_sync
        self.adaptive_rounds = max(steps_per_sync * adaptive_mult,
                                   steps_per_sync + 1)
        self.join_fast_sync = join_fast_sync and steps_per_sync > 1
        self.kv_int8 = kv_int8
        self.tokenizer = tokenizer or get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language,
        )
        options = DecodingOptions(language=language, without_timestamps=True)
        self.prefix = initial_tokens(self.tokenizer, options)
        self.n_prefix = len(self.prefix)
        # a (K + 1)-wide verification block needs K rows and positions of
        # headroom past the frontier (the K/V writes do not clamp)
        ctx_cap = cfg.n_text_ctx - draft_k
        if draft_cfg is not None:
            ctx_cap = min(ctx_cap, draft_cfg.n_text_ctx - draft_k)
        self.n_ctx = min(self.n_prefix + max_new_tokens + 1, ctx_cap)
        self.max_new = self.n_ctx - self.n_prefix - 1
        self._cache_len = self.n_ctx + draft_k
        self._tree_join_width = (None if tree_k is None
                                 else max(self.n_prefix, tree_k + 2))
        self.eot = self.tokenizer.eot
        dev = self.device
        self.suppress = torch.from_numpy(
            build_suppress_mask(self.tokenizer, options, cfg.n_vocab)).to(dev)
        self.blank = torch.from_numpy(
            build_blank_mask(self.tokenizer, cfg.n_vocab)).to(dev)

        with torch.inference_mode():
            # persistent device state: an all-empty batch
            self.cache = self._empty_cache(self.params, cfg)
            self.draft_cache = (
                None if draft_cfg is None else
                self._empty_cache(self.draft_params, draft_cfg))
            self.hidden_frontier = None
            if medusa_params is not None:
                self.hidden_frontier = torch.zeros(
                    (slots, cfg.n_text_state), dtype=self.dtype, device=dev)
            self.last_tok = torch.full((slots,), self.eot, dtype=torch.long,
                                       device=dev)
            self.lens = torch.full((slots,), self.n_prefix, dtype=torch.long,
                                   device=dev)
            self.finished = torch.ones(slots, dtype=torch.bool, device=dev)
            self._prefix_dev = torch.tensor(self.prefix, dtype=torch.long,
                                            device=dev)
        self._prefix_row = np.asarray(self.prefix, np.int64)

        self._slots: List[Optional[_Slot]] = [None] * slots
        self._queue: "queue.Queue" = queue.Queue()  # (slot, audio) pairs
        self.max_pending = max_pending
        # finished-window requests waiting to rejoin for their next window
        self._continuations: List[tuple] = []
        self._stop = threading.Event()
        # client threads submit concurrently: the queue bound's check and
        # put, and their counts, happen under one lock
        self._submit_lock = threading.Lock()
        # counts the reference has not: "steps", the decode steps run (on
        # CUDA, K4 launches n_text_layer times a step), and
        # "spec_slot_rounds", the (slot, round) pairs of speculative chunks
        # in which a slot emitted (spec_emitted over it: tokens a round)
        self._stats = {
            "requests": 0, "joins": 0, "chunks": 0, "fast_chunks": 0,
            "long_chunks": 0, "spec_rounds": 0, "spec_emitted": 0,
            "rejected": 0, "cancelled": 0, "timed_out": 0, "steps": 0,
            "spec_slot_rounds": 0,
        }
        if prewarm:
            self._prewarm()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------

    def submit(
        self,
        audio,
        on_token: Optional[Callable[[dict], None]] = None,
        on_partial: Optional[Callable[[dict], None]] = None,
        deadline_sec: Optional[float] = None,
    ) -> Future:
        """Submit one utterance (path or 16 kHz waveform; 30 s windows
        decoded one after another).

        on_token: called from the engine thread with {"token", "window",
        "text_so_far"} per decoded token; on_partial is an alias (the HTTP
        stream handler uses it). deadline_sec: wall-clock budget from now;
        past it the request resolves at the next sync with what it has
        (``timed_out: True``). ``.cancel()`` on the Future drops the
        request (queued ones never run; in-flight ones stop at the next
        sync). Raises EngineOverloaded when max_pending requests wait.
        """
        on_token = on_token or on_partial
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        windows = [
            pad_or_trim(audio[s:s + N_SAMPLES])
            for s in range(0, max(len(audio), 1), N_SAMPLES)
        ]
        fut: Future = Future()
        slot = _Slot(
            future=fut,
            windows=windows[1:],
            submitted_at=time.time(),
            on_token=on_token,
            deadline=(time.time() + deadline_sec
                      if deadline_sec is not None else None),
        )
        with self._submit_lock:
            waiting = self._queue.qsize()
            if self.max_pending is not None and waiting >= self.max_pending:
                self._stats["rejected"] += 1
                raise EngineOverloaded(
                    f"{waiting} requests already waiting "
                    f"(max_pending={self.max_pending})"
                )
            self._queue.put((slot, windows[0]))
            self._stats["requests"] += 1
        return fut

    def transcribe(self, audio, timeout: Optional[float] = None) -> dict:
        return self.submit(audio).result(timeout=timeout)

    def stats(self) -> dict:
        with self._submit_lock:
            d = dict(self._stats)
        d["pending"] = self._queue.qsize()
        d["active_slots"] = sum(s is not None for s in self._slots)
        return d

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)

    # -- engine -----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _empty_cache(self, params, cfg: WhisperConfig) -> DecoderCache:
        """A cache of every slot, _cache_len rows, from all-zero features."""
        dummy = torch.zeros((self.slots, cfg.n_audio_ctx, cfg.n_audio_state),
                            dtype=self.dtype, device=self.device)
        return init_cache(params, cfg, dummy, max_len=self._cache_len,
                          dtype=self.dtype, cross_kv_int8=self.kv_int8)

    def _install(self, i: int, audio: np.ndarray):
        """One window's log-mel, encoder forward and cross K/V, on the
        device, copied into slot i of the persistent cache; with a draft
        model, its encoder forward and cross K/V from the same log-mel into
        slot i of the draft's cache."""
        wave = torch.from_numpy(audio).to(self.device)
        mel = log_mel_spectrogram(wave[None], n_mels=self.cfg.n_mels)
        for params, cfg, cache in ((self.params, self.cfg, self.cache),
                                   (self.draft_params, self.draft_cfg,
                                    self.draft_cache)):
            if params is None:
                continue
            feats = _encode_one(params, cfg, mel, dtype=self.dtype)
            one = _cross_kv_one(params, cfg, feats, dtype=self.dtype,
                                cross_kv_int8=self.kv_int8)
            _scatter_slot(cache, one, i)

    def _admit(self) -> bool:
        """Join queued requests into free slots. Returns True if any.

        Window continuations (long audio) are admitted before new requests
        so an utterance in progress never starves behind fresh arrivals.
        """
        free = self._free_slots()
        joiners = []
        while free and (self._continuations or not self._queue.empty()):
            if self._continuations:
                slot_state, audio = self._continuations.pop(0)
            else:
                try:
                    slot_state, audio = self._queue.get_nowait()
                except queue.Empty:
                    break
            # cancelled or expired requests never pay for the encoder
            if slot_state.future.cancelled():
                self._stats["cancelled"] += 1
                continue
            if (
                slot_state.deadline is not None
                and time.time() > slot_state.deadline
            ):
                slot_state.timed_out = True
                self._stats["timed_out"] += 1
                self._resolve(slot_state)
                continue
            i = free.pop(0)
            self._install(i, audio)
            if not slot_state.started_at:
                slot_state.started_at = time.time()
            self._slots[i] = slot_state
            joiners.append(i)

        if not joiners:
            return False
        self._join(joiners)
        B, P = self.slots, self.n_prefix
        join_mask = np.zeros(B, bool)
        join_mask[joiners] = True
        join_mask = torch.from_numpy(join_mask).to(self.device)
        self.last_tok = torch.where(join_mask, self._prefix_dev[-1],
                                    self.last_tok)
        self.lens = torch.where(join_mask, P, self.lens)
        self.finished = self.finished & ~join_mask
        self._stats["joins"] += len(joiners)
        return True

    def _history(self, b: int) -> List[int]:
        """Slot b's context on the host: the prefix and its window's tokens."""
        s = self._slots[b]
        return list(self.prefix) + (s.tokens if s is not None else [])

    def _join(self, joiners: List[int]):
        """One batched prefix pass: joiners consume the SOT prefix at 0,
        every other slot re-feeds its latest n_prefix tokens in place; the
        draft model's cache takes the same rows. With Medusa heads the pass
        also gives every slot's frontier hidden state, and in tree mode it
        re-feeds W = max(n_prefix, tree_K + 2) rows a slot (see
        ``_join_step_tree``)."""
        B, P, dev = self.slots, self.n_prefix, self.device
        lens_np = self.lens.cpu().numpy()
        tok_rows = np.tile(self._prefix_row, (B, 1))
        pos = np.maximum(lens_np - P, 0)
        for b in range(B):
            if b in joiners:
                pos[b] = 0
                continue
            tail = self._history(b)[pos[b]:pos[b] + P]
            tok_rows[b, :len(tail)] = tail
        tok_rows = torch.from_numpy(tok_rows).to(dev)
        pos = torch.from_numpy(pos).to(dev)
        if self.medusa_tree is not None:
            W = self._tree_join_width
            rows = np.full((B, W), self.eot, np.int64)
            starts = np.zeros(B, np.int64)
            lens_eff = np.zeros(B, np.int64)
            for b in range(B):
                hist = self._history(b)
                lens_eff[b] = len(hist)
                starts[b] = max(len(hist) - W, 0)
                seg = hist[starts[b]:starts[b] + W]
                rows[b, :len(seg)] = seg
            self.cache, self.hidden_frontier = _join_step_tree(
                self.params, self.cfg, self.cache,
                *(torch.from_numpy(a).to(dev)
                  for a in (rows, starts, lens_eff)),
                dtype=self.dtype)
        elif self.medusa_params is not None:
            # every slot's frontier sits at block index P - 2: joiners by
            # construction, re-feeders because chain rounds write every
            # accepted token's K/V
            self.cache, self.hidden_frontier = _join_step_hidden(
                self.params, self.cfg, self.cache, tok_rows, pos,
                dtype=self.dtype)
        else:
            self.cache = _join_step(self.params, self.cfg, self.cache,
                                    tok_rows, pos, dtype=self.dtype)
        if self.draft_params is not None:
            self.draft_cache = _join_step(self.draft_params, self.draft_cfg,
                                          self.draft_cache, tok_rows, pos,
                                          dtype=self.dtype)

    def _resolve(self, s: _Slot):
        """Resolve a request's Future with its final transcript."""
        if s.future.done():  # cancelled under our feet
            return
        tokens = s.all_tokens()
        text = self.tokenizer.decode_text(tokens).strip()
        try:
            s.future.set_result(
                {
                    "text": text,
                    "tokens": tokens,
                    "n_windows": len(s.window_tokens),
                    "latency_sec": time.time() - s.submitted_at,
                    "queue_sec": (
                        (s.started_at - s.submitted_at)
                        if s.started_at
                        else None  # expired while still queued
                    ),
                    "ttft_sec": (
                        (s.first_token_at - s.submitted_at)
                        if s.first_token_at
                        else None  # produced no tokens (immediate EOT)
                    ),
                    "truncated": s.truncated,
                    "timed_out": s.timed_out,
                }
            )
        except Exception:
            pass  # a cancel() racing set_result

    def _retire(self, i: int, budget_hit: bool):
        """Finish the current window; chain the next or resolve."""
        s = self._slots[i]
        if s is None:
            return
        s.truncated = s.truncated or budget_hit
        s.window_tokens.append(list(s.tokens))
        s.tokens = []
        self._slots[i] = None
        if s.windows:
            # long audio: requeue for the next 30 s window (the slot is
            # freed; another request may use it meanwhile)
            self._continuations.append((s, s.windows.pop(0)))
            return
        self._resolve(s)

    def _halt_device_slot(self, i: int):
        """Mark slot i finished on the device so a forced retire stops
        spending steps on a dead request (a join resets the flag)."""
        self.finished[i] = True

    def _force_retire(self, i: int, cancelled: bool):
        """Drop an in-flight request now (client cancel or deadline)."""
        s = self._slots[i]
        if s is None:
            return
        self._slots[i] = None
        self._halt_device_slot(i)
        if cancelled:
            self._stats["cancelled"] += 1
            return  # the Future is already CANCELLED
        s.timed_out = True
        self._stats["timed_out"] += 1
        s.window_tokens.append(list(s.tokens))
        s.tokens = []
        self._resolve(s)  # partial transcript, timed_out set

    def _reap(self):
        """Apply client cancels and deadlines to in-flight slots, to
        requests waiting between windows and to the waiting queue."""
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.future.cancelled():
                self._force_retire(i, cancelled=True)
            elif s.deadline is not None and now > s.deadline:
                self._force_retire(i, cancelled=False)
        if self._continuations:
            keep = []
            for s, audio in self._continuations:
                if s.future.cancelled():
                    self._stats["cancelled"] += 1
                elif s.deadline is not None and now > s.deadline:
                    s.timed_out = True
                    self._stats["timed_out"] += 1
                    self._resolve(s)
                else:
                    keep.append((s, audio))
            self._continuations = keep
        # the waiting queue too: with every slot busy _admit never pops it,
        # so an expired or cancelled request would otherwise wait for a
        # free slot and keep counting toward max_pending
        if not self._queue.empty():
            keep_q = []
            while True:
                try:
                    s, audio = self._queue.get_nowait()
                except queue.Empty:
                    break
                if s.future.cancelled():
                    self._stats["cancelled"] += 1
                elif s.deadline is not None and now > s.deadline:
                    s.timed_out = True
                    self._stats["timed_out"] += 1
                    self._resolve(s)
                else:
                    keep_q.append((s, audio))
            for item in keep_q:  # FIFO order kept for the survivors
                self._queue.put(item)

    def _prewarm(self):
        """Run every device function of the path once, in __init__, so that
        every kernel it reaches is built before the engine thread starts: a
        silent window's log-mel, encoder forward and cross K/V (not
        installed; the draft model's too), a join of the prefix into every
        (empty) slot, and one chunk step, or with draft_k > 0 one
        speculative chunk of each variant the loop runs (steps_per_sync
        rounds, 1 with join_fast_sync, adaptive_rounds with adaptive_sync),
        as the reference's prewarm. Every slot stays finished, so a chunk
        emits nothing and leaves lens, finished and last_tok as they are;
        the rows it writes lie in empty slots, which a join rewrites before
        any read. The stats are reset afterwards."""
        B, P = self.slots, self.n_prefix
        with torch.inference_mode():
            wave = torch.zeros((1, N_SAMPLES), device=self.device)
            mel = log_mel_spectrogram(wave, n_mels=self.cfg.n_mels)
            for params, cfg in ((self.params, self.cfg),
                                (self.draft_params, self.draft_cfg)):
                if params is not None:
                    feats = _encode_one(params, cfg, mel, dtype=self.dtype)
                    _cross_kv_one(params, cfg, feats, dtype=self.dtype,
                                  cross_kv_int8=self.kv_int8)
            self._join(list(range(B)))
            if self.draft_k > 0:
                variants = [self.steps_per_sync]
                if self.join_fast_sync and 1 not in variants:
                    variants.append(1)
                if self.adaptive_sync and self.adaptive_rounds not in variants:
                    variants.append(self.adaptive_rounds)
                for rounds in variants:
                    self._spec_round([], rounds)
            else:
                self.cache, self.last_tok, self.lens, self.finished, _, _ = (
                    _decode_chunk(
                        self.params, self.cfg, self.cache, self.last_tok,
                        self.lens, self.finished, self.suppress, self.blank,
                        self.eot, 1, P, self.max_new, dtype=self.dtype,
                    )
                )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        for k in ("chunks", "fast_chunks", "long_chunks", "steps",
                  "spec_rounds", "spec_emitted", "spec_slot_rounds"):
            self._stats[k] = 0

    def _tokens_buf(self):
        """(slots, _cache_len) long on the device: each slot's history, EOT
        past it (the n-gram and tree chunks' token buffer)."""
        buf = np.full((self.slots, self._cache_len), self.eot, np.int64)
        for b in range(self.slots):
            hist = self._history(b)[:self._cache_len]
            buf[b, :len(hist)] = hist
        return torch.from_numpy(buf).to(self.device)

    def _spec_round(self, active: List[int], rounds: int):
        """One speculative chunk (draft_k > 0): ``rounds`` verification
        rounds on the device (n-gram, draft model, Medusa chain or tree),
        then one host sync that unpacks every round's emissions: the greedy
        engine's tokens, 1 to K + 1 a round a slot."""
        args = (self.last_tok, self.lens, self.finished, self.suppress,
                self.blank, self.eot, rounds)
        if self.medusa_tree is not None:
            (self.cache, self.hidden_frontier, self.last_tok, self.lens,
             self.finished, emits, vs) = _spec_chunk_medusa_tree(
                self.params, self.medusa_params, self.cfg, self.cache,
                self._tokens_buf(), self.hidden_frontier, *args,
                self.n_prefix, self.max_new, dtype=self.dtype,
                tree=self.medusa_tree)
        elif self.medusa_params is not None:
            (self.cache, self.hidden_frontier, self.last_tok, self.lens,
             self.finished, emits, vs) = _spec_chunk_medusa(
                self.params, self.medusa_params, self.cfg, self.cache,
                self.hidden_frontier, *args, self.n_prefix, self.max_new,
                dtype=self.dtype)
        elif self.draft_params is not None:
            (self.cache, self.draft_cache, self.last_tok, self.lens,
             self.finished, emits, vs) = _spec_chunk_model(
                self.params, self.draft_params, self.cfg, self.draft_cfg,
                self.cache, self.draft_cache, *args, self.draft_k,
                self.n_prefix, self.max_new, dtype=self.dtype)
        else:
            (self.cache, self.last_tok, self.lens, self.finished, emits,
             vs) = _spec_chunk(
                self.params, self.cfg, self.cache, self._tokens_buf(), *args,
                self.draft_k, self.n_prefix, self.max_new, dtype=self.dtype)
        # the host sync: every round's emissions and counts in one copy
        host = torch.cat([emits, vs[..., None]], dim=2).cpu().numpy()
        emits_np, vs_np = host[..., :-1], host[..., -1]
        self._stats["chunks"] += 1
        self._stats["spec_rounds"] += rounds
        self._stats["spec_slot_rounds"] += int((vs_np > 0).sum())
        for b in active:
            s = self._slots[b]
            done = False
            for r in range(rounds):
                for t in emits_np[r, b, :vs_np[r, b]].tolist():
                    if t == self.eot:
                        done = True
                        break
                    self._emit_token(s, t)
                    self._stats["spec_emitted"] += 1
                if done:
                    break
            budget_hit = len(s.tokens) >= self.max_new
            if done or budget_hit:
                self._retire(b, budget_hit and not done)

    def _emit_token(self, s: _Slot, t: int):
        """Append one decoded token to a request and stream it."""
        s.tokens.append(t)
        if not s.first_token_at:
            s.first_token_at = time.time()
        if s.on_token is not None:
            try:
                s.on_token(
                    {
                        "token": t,
                        "window": len(s.window_tokens),
                        "text_so_far": self.tokenizer.decode_text(
                            s.all_tokens()),
                    }
                )
            except Exception:
                pass

    def _loop(self):
        while not self._stop.is_set():
            try:
                with torch.inference_mode():
                    self._loop_once()
            except Exception as e:
                # fail every pending request loudly instead of leaving
                # futures hanging on a dead engine thread
                for i, s in enumerate(self._slots):
                    if s is not None and not s.future.done():
                        s.future.set_exception(e)
                    self._slots[i] = None
                while True:
                    try:
                        slot_state, _ = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if not slot_state.future.done():
                        slot_state.future.set_exception(e)
                for slot_state, _ in self._continuations:
                    if not slot_state.future.done():
                        slot_state.future.set_exception(e)
                self._continuations.clear()
                raise

    def _loop_once(self):
        self._reap()
        admitted = self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            if not admitted:
                time.sleep(0.002)
            return

        # TTFT fast path: a slot just joined, so sync after one round
        rounds = self.steps_per_sync
        if self.join_fast_sync and admitted:
            rounds = 1
            self._stats["fast_chunks"] += 1
        elif (
            self.adaptive_sync
            and self._queue.empty()
            and not self._continuations
        ):
            # nothing waits to join: a long chunk saves host syncs; the
            # all-halted check stops it once every slot drains
            rounds = self.adaptive_rounds
            self._stats["long_chunks"] += 1

        if self.draft_k > 0:
            self._spec_round(active, rounds)
            return

        (
            self.cache,
            self.last_tok,
            self.lens,
            self.finished,
            toks,
            steps_run,
        ) = _decode_chunk(
            self.params, self.cfg, self.cache, self.last_tok, self.lens,
            self.finished, self.suppress, self.blank, self.eot, rounds,
            self.n_prefix, self.max_new, dtype=self.dtype,
        )
        # the host sync: the emitted tokens and the lengths in one copy
        host = torch.cat([toks, self.lens[None]]).cpu().numpy()
        toks_np, lens_np = host[:-1], host[-1]
        self._stats["chunks"] += 1
        self._stats["steps"] += steps_run
        for b in active:
            s = self._slots[b]
            done = False
            for t in toks_np[:, b].tolist():
                if t == self.eot:
                    done = True
                    break
                if t < 0:  # halted on the device (budget frozen)
                    break
                self._emit_token(s, int(t))
            budget_hit = lens_np[b] - self.n_prefix >= self.max_new
            if done or budget_hit:
                self._retire(b, budget_hit and not done)
