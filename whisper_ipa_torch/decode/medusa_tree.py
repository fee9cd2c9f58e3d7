"""Tree-structured Medusa verification: many drafts, one forward.

Counterpart of ``whisper_ipa_tpu/decode/medusa_tree.py``. Chain speculation
(``speculative.py``) verifies one candidate a draft position; a draft tree
verifies several at once, all in the same (R + N)-query forward.

A round (``tree_round``, shared with the in-flight engine's chunk):
  1. re-feed: the last R = K + 2 tokens before ``lens`` enter the decoder
     again at their real positions. Rows already in the cache are written
     again from the same tokens; the tokens accepted last round get their
     first write. After it the cache is valid below ``lens`` every round.
  2. tree: N draft nodes follow. Node n holds candidate ``cand[n]`` of head
     ``depth[n] - 1`` (``medusa_propose_topk``), sits at position
     lens + depth[n] - 1 (siblings share it and are never written), and
     attends the real re-fed context and its own tree ancestors only.
  3. accept: walk the depths greedily. The root's logits give the greedy
     token g0; if a depth-1 node carries g0, its logits give g1; and so on.
     The emitted tokens are exactly the target's greedy decode.

The tree is a static template: a tuple of (parent, cand) pairs, parent -1
for a depth-1 node, else the index of an earlier node. The default 9-node
tree spends its nodes where acceptance decays: 3 candidates at depth 1, 3
at depth 2, 2 at depth 3, 1 at depth 4. ``optimize_tree`` builds the tree
of highest expected acceptance from measured per-head accuracies
(``cli/train_medusa.py`` writes them beside the heads), and
``tree_for_heads`` picks it when that file exists.

The reference runs the loop as one ``lax.while_loop``; here it is an eager
loop that asks the host whether every row finished only every
``FINISHED_CHECK_EVERY`` rounds, and counts only rounds with an active row.
"""

from __future__ import annotations

import heapq
import json
import os
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.medusa import medusa_propose_topk
from ..models.whisper import (
    cast_decoder_blocks,
    decode_step_block,
    decode_step_multipos_hidden,
    init_cache,
)
from ..ops.precision import full_fp32
from ..tokenizer import WhisperTokenizer
from .decoding import FINISHED_CHECK_EVERY, DecodingOptions, DecodingResult
from .speculative import (
    SpeculativeStats,
    _accept,
    _emit,
    _Setup,
    check_greedy_options,
)

Tree = Tuple[Tuple[int, int], ...]

# (parent, cand) per node; parent -1 = a depth-1 node.
# 3 roots, then 2 + 1 at depth 2, 2 at depth 3, 1 at depth 4.
DEFAULT_TREE: Tree = (
    (-1, 0), (-1, 1), (-1, 2),      # nodes 0..2   depth 1
    (0, 0), (0, 1), (1, 0),         # nodes 3..5   depth 2
    (3, 0), (4, 0),                 # nodes 6..7   depth 3
    (6, 0),                         # node  8      depth 4
)


def optimize_tree(cand_probs, n_nodes: int) -> Tree:
    """The static tree of highest expected acceptance.

    cand_probs[k][c]: the measured probability that head k's c-th
    candidate equals the greedy token at its position. The expected number
    of accepted nodes a round is the sum over nodes of their path
    probability (the product along the path), so the best n_nodes-node
    tree holds the n_nodes most probable paths; they are closed under
    prefixes, so best-first expansion finds them.
    """
    cand_probs = np.asarray(cand_probs, np.float64)
    K, C = cand_probs.shape
    # heap entries: (-path probability, depth, parent node, candidate)
    heap = [(-cand_probs[0, c], 1, -1, c) for c in range(C)]
    heapq.heapify(heap)
    tree: List[Tuple[int, int]] = []
    while heap and len(tree) < n_nodes:
        neg_p, d, parent, c = heapq.heappop(heap)
        node_id = len(tree)
        tree.append((parent, c))
        if d < K:
            for cc in range(C):
                child_p = -neg_p * cand_probs[d, cc]
                if child_p > 0:
                    heapq.heappush(heap, (-child_p, d + 1, node_id, cc))
    return tuple(tree)


def tree_for_heads(medusa_weights_path: str, n_nodes: int = 12) -> Tree:
    """The serving tree: optimized from the ``<weights>.accuracy.json``
    that ``cli.train_medusa`` writes, ``DEFAULT_TREE`` without it."""
    sidecar = medusa_weights_path + ".accuracy.json"
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            probs = json.load(f)["head_topk_accuracy"]
        return optimize_tree(probs, n_nodes)
    return DEFAULT_TREE


def _tree_tables(tree):
    """Per-node depth, parent, candidate, the ancestor mask (anc[i, j]: j
    is i or an ancestor of i), the candidate count and the depth."""
    n = len(tree)
    depth = np.zeros(n, np.int64)
    parent = np.array([p for p, _ in tree], np.int64)
    cand = np.array([c for _, c in tree], np.int64)
    anc = np.zeros((n, n), bool)
    for i, (p, _) in enumerate(tree):
        if p < 0:
            depth[i] = 1
        else:
            assert p < i, "tree nodes must come after their parents"
            depth[i] = depth[p] + 1
        anc[i, i] = True
        if p >= 0:
            anc[i] |= anc[p]
    return depth, parent, cand, anc, int(cand.max()) + 1, int(depth.max())


@lru_cache(maxsize=32)
def _device_tables(tree: Tree, device: torch.device):
    """``_tree_tables``' arrays on ``device``, copied once a tree."""
    depth, parent, cand, anc, _, _ = _tree_tables(tree)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (depth, parent, cand, anc))


def tree_round(
    params,
    medusa_params,
    cfg: WhisperConfig,
    cache,
    tokens_buf,  # (B, buf_len): context tokens, EOT past lens
    hidden_frontier,  # (B, d): hidden of the input at lens - 2
    lens,  # (B,)
    suppress_mask,
    blank_mask,
    n_prefix: int,
    tree,
    dtype,
    tp=None,
):
    """One tree verification forward and the greedy acceptance walk.

    Returns (cache, emit (B, K + 1) greedy-path tokens, emit_lp (B, K + 1)
    their log-probabilities, sel (B, K + 1) the block index whose hidden
    follows each emit, m (B,) matched node count, hidden (B, S, d) the
    block's hidden states).
    """
    tree = tuple(tuple(node) for node in tree)
    _, _, _, _, max_c, K = _tree_tables(tree)
    N = len(tree)
    R = K + 2  # the re-feed: the K + 1 most accepted and the root
    B = tokens_buf.shape[0]
    device = tokens_buf.device
    depth, parent, cand, anc = _device_tables(tree, device)

    # -- draft the tree from the frontier hidden
    topk = medusa_propose_topk(medusa_params, params, hidden_frontier, max_c,
                               dtype)  # (B, K, C)
    node_tok = topk[:, depth - 1, cand]  # (B, N): cand[n] of head depth[n]-1

    # -- the block: R re-fed tokens, then the N tree nodes
    start = (lens - R).clamp_min(0)
    refeed_pos = start[:, None] + torch.arange(R, device=device)[None, :]
    refeed_tok = tokens_buf.gather(1, refeed_pos)
    node_pos = lens[:, None] + (depth - 1)[None, :]
    block_tok = torch.cat([refeed_tok, node_tok], dim=1)
    block_pos = torch.cat([refeed_pos, node_pos], dim=1)

    # -- the additive in-block mask: the re-feed is causal over its real
    # entries (pos < lens); a node sees the real re-feed and its ancestors
    real = refeed_pos < lens[:, None]  # (B, R)
    m_rr = real[:, None, :] & (refeed_pos[:, None, :] <= refeed_pos[:, :, None])
    m_rn = torch.zeros((B, R, N), dtype=torch.bool, device=device)
    m_nr = real[:, None, :].expand(B, N, R)
    m_nn = anc[None].expand(B, N, N)
    allowed = torch.cat([torch.cat([m_rr, m_rn], dim=2),
                         torch.cat([m_nr, m_nn], dim=2)], dim=1)
    mask_new = torch.where(allowed, torch.zeros((), device=device),
                           torch.full((), float("-inf"), device=device))

    logits, cache, hidden = decode_step_block(
        params, cfg, block_tok, cache, block_pos, start, mask_new,
        write_len=R, dtype=dtype, tp=tp,
    )

    # -- the greedy choice at every entry (suppress + first-token blank)
    lg = logits + suppress_mask
    lg = torch.where((block_pos + 1 == n_prefix)[..., None], lg + blank_mask,
                     lg)
    greedy_all = lg.argmax(dim=-1)  # (B, S)
    lp_all = lg.amax(dim=-1) - torch.logsumexp(lg, dim=-1)

    # -- walk the tree: accept the nodes that carry the running greedy token
    def take(arr, i):
        return arr.gather(1, i[:, None])[:, 0]

    root_idx = lens - 1 - start  # block index of the input at lens - 1
    g, lp = take(greedy_all, root_idx), take(lp_all, root_idx)
    emits, lps, sel_idx = [g], [lp], [root_idx]
    cur_node = torch.full((B,), -1, dtype=torch.long, device=device)
    alive = torch.ones(B, dtype=torch.bool, device=device)
    m = torch.zeros(B, dtype=torch.long, device=device)
    for d in range(1, K + 1):
        # at most one node matches: a head's top-C candidates are distinct
        cand_mask = ((depth[None, :] == d)
                     & (parent[None, :] == cur_node[:, None])
                     & (node_tok == g[:, None]))  # (B, N)
        alive = alive & cand_mask.any(dim=1)
        idx = cand_mask.to(torch.uint8).argmax(dim=1)
        m = m + alive
        cur_node = torch.where(alive, idx, cur_node)
        blk = R + idx
        g = torch.where(alive, take(greedy_all, blk), g)
        lp = torch.where(alive, take(lp_all, blk), lp)
        emits.append(g)
        lps.append(lp)
        sel_idx.append(torch.where(alive, blk, sel_idx[-1]))
    return (cache, torch.stack(emits, dim=1), torch.stack(lps, dim=1),
            torch.stack(sel_idx, dim=1), m, hidden)


def _tree_decode(
    params,
    medusa_params,
    cfg: WhisperConfig,
    audio_features,
    prefix_tokens,  # (B, n_prefix)
    suppress_mask,
    blank_mask,
    eot: int,
    sample_len: int,
    dtype: torch.dtype,
    sot_index: int,
    cross_kv_int8: bool,
    cross_kv_int4: bool,
    tree: Tree,
    tp=None,
):
    """The batched round loop; returns (tokens, sum_logprobs, sot_logits,
    rounds, emitted) as ``speculative._spec_decode`` does."""
    params = cast_decoder_blocks(params, dtype)
    K = _tree_tables(tree)[5]
    B, n_prefix = prefix_tokens.shape
    device = audio_features.device
    buf_len = n_prefix + sample_len + K + 2

    cache = init_cache(
        params, cfg, audio_features, max_len=buf_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4, tp=tp,
    )
    # the prefix pass; the heads draft from the hidden of the input at
    # lens - 2
    prefix_logits, cache, prefix_hidden = decode_step_multipos_hidden(
        params, cfg, prefix_tokens, cache,
        torch.zeros(B, dtype=torch.long, device=device), dtype=dtype, tp=tp,
    )
    sot_logits = prefix_logits[:, sot_index]
    hidden_frontier = prefix_hidden[:, n_prefix - 2]

    tokens_buf = torch.full((B, buf_len), eot, dtype=torch.long, device=device)
    tokens_buf[:, :n_prefix] = prefix_tokens
    lens = torch.full((B,), n_prefix, dtype=torch.long, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros(B, dtype=torch.float32, device=device)
    rounds = torch.zeros((), dtype=torch.long, device=device)
    emitted = torch.zeros((), dtype=torch.long, device=device)
    rows = torch.arange(B, device=device)

    for it in range(sample_len):
        if it and it % FINISHED_CHECK_EVERY == 0 and bool(finished.all()):
            break
        rounds = rounds + (~finished).any()
        cache, emit, emit_lp, sel, m, hidden = tree_round(
            params, medusa_params, cfg, cache, tokens_buf, hidden_frontier,
            lens, suppress_mask, blank_mask, n_prefix, tree, dtype, tp=tp,
        )
        # EOT and budget: the chain's contract
        v, has_eot = _accept(emit, m, lens, finished, n_prefix, sample_len,
                             eot)
        sum_logprobs = _emit(tokens_buf, lens, emit, emit_lp, v,
                             sum_logprobs, eot)
        lens = lens + v
        finished = finished | has_eot | (lens - n_prefix >= sample_len)
        emitted = emitted + v.sum()
        # the hidden of the input at (new lens) - 2 feeds the next drafts:
        # the accepted node at depth v - 1, or the root input for v == 1
        pick = sel.gather(1, (v - 1).clamp_min(0)[:, None])[:, 0]
        hidden_frontier = torch.where((v >= 1)[:, None], hidden[rows, pick],
                                      hidden_frontier)
    return tokens_buf, sum_logprobs, sot_logits, rounds, emitted


def medusa_tree_decode(
    params,
    cfg: WhisperConfig,
    medusa_params,
    mel,
    options: DecodingOptions = DecodingOptions(),
    tree: Tree = DEFAULT_TREE,
    tokenizer: Optional[WhisperTokenizer] = None,
    return_stats: bool = False,
    *,
    tp=None,
) -> List[DecodingResult]:
    """Greedy decode accelerated by tree-verified Medusa drafts; the tokens
    are exactly ``decode(params, cfg, mel, options)``'s. The restrictions
    of chain speculation apply, and the tree may be no deeper than the
    heads. With ``return_stats`` returns (results, SpeculativeStats).
    ``tp`` as in ``speculative_decode`` (the heads stay whole)."""
    check_greedy_options(options, "medusa_tree_decode")
    tree = tuple(tuple(node) for node in tree)
    K = _tree_tables(tree)[5]
    n_heads = len(medusa_params["heads"])
    if K > n_heads:
        raise ValueError(f"tree depth {K} exceeds the {n_heads} trained heads")

    with torch.inference_mode(), full_fp32():
        setup = _Setup(params, cfg, mel, options, tokenizer, tp=tp)
        sample_len = options.sample_len or (cfg.n_text_ctx // 2)
        sample_len = min(sample_len, cfg.n_text_ctx - setup.n_prefix - K - 2)
        tokens, sum_logprobs, sot_logits, rounds, emitted = _tree_decode(
            params, medusa_params, cfg, setup.audio_features,
            setup.prefix_tokens, setup.suppress_mask, setup.blank_mask,
            setup.tokenizer.eot, int(sample_len), setup.dtype,
            setup.sot_index, options.kv_int8, options.kv_int4, tree, tp=tp,
        )
        results = setup.results(options, tokens, sum_logprobs, sot_logits,
                                sample_len)
        stats = SpeculativeStats(rounds=int(rounds), emitted_tokens=int(emitted),
                                 draft_k=K, batch=len(results))
    if return_stats:
        return results, stats
    return results
