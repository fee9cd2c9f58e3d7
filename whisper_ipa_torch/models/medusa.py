"""Medusa draft heads: one-shot multi-token proposals for speculative
decoding.

Counterpart of ``whisper_ipa_tpu/models/medusa.py``. K small residual heads
sit on the decoder's final hidden state h_t: head k maps h_t to
``h + W2 gelu(W1 h + b1) + b2`` and predicts token t+k+2 through the tied
token embedding (Medusa-1, Cai et al. 2024). The heads are a parameter tree
of their own, ``{"heads": [{"w1", "b1", "w2", "b2"}, ...]}``, stored in
their own safetensors file under the reference's names
``heads.{k}.{w1,b1,w2,b2}``, so a heads file written by either package
loads in the other.

Training (``train_medusa_step``) keeps the base model frozen: one
teacher-forced decoder pass gives the hidden states, and each head gets a
cross-entropy loss against the (k+2)-shifted targets. Decoding never
depends on head quality: verification accepts only the target's own greedy
tokens (``decode/speculative.py``, ``decode/medusa_tree.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import WhisperConfig
from ..ops.precision import full_fp32
from . import safetensors_io
from .convert import flatten_params, unflatten_params
from .layers import gelu

HEAD_KEYS = ("w1", "b1", "w2", "b2")


def init_medusa_params(cfg: WhisperConfig, n_heads: int = 4, seed: int = 0,
                       device=None) -> Dict:
    """K residual heads, drawn on the CPU from a ``torch.Generator`` seeded
    with ``seed`` (the reference's shapes and scales; its numbers come from
    ``jax.random``): W1 ~ N(0, 1/d), and W2, b1, b2 zero, so a fresh head
    is the identity over h and predicts as the base logits head does."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = cfg.n_text_state
    heads = []
    for _ in range(n_heads):
        heads.append({
            "w1": (torch.randn((d, d), generator=gen) * d ** -0.5).to(device),
            "b1": torch.zeros(d, device=device),
            "w2": torch.zeros((d, d), device=device),
            "b2": torch.zeros(d, device=device),
        })
    return {"heads": heads}


def _head_hidden(h, head, dtype):
    """h: (..., d) -> the residual head's hidden state (..., d)."""
    z = gelu(h @ head["w1"].to(dtype) + head["b1"].to(dtype))
    return h + z @ head["w2"].to(dtype) + head["b2"].to(dtype)


def _head_logits(medusa_params: Dict, params: Dict, hidden, dtype):
    """Each head's logits (..., n_vocab) in float32, a list over heads."""
    emb = params["decoder"]["token_embedding"].float()
    with full_fp32():
        h = hidden.to(dtype)
        return [_head_hidden(h, head, dtype).float() @ emb.T
                for head in medusa_params["heads"]]


def medusa_propose(medusa_params: Dict, params: Dict, hidden,
                   dtype=torch.float32):
    """Greedy one-shot proposals from the frontier hidden states
    (B, d): (B, K) long draft tokens."""
    return torch.stack(
        [lg.argmax(dim=-1)
         for lg in _head_logits(medusa_params, params, hidden, dtype)],
        dim=-1,
    )


def _top_c(logits, c: int):
    """The c largest entries' indices, highest first, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :c]


def medusa_propose_topk(medusa_params: Dict, params: Dict, hidden, top_c: int,
                        dtype=torch.float32):
    """Top-C proposals per head: hidden (..., d) -> (..., K, C) long,
    candidates ordered by head probability. Tree verification draws each
    node's token from here (``decode/medusa_tree.py``)."""
    return torch.stack(
        [_top_c(lg, top_c)
         for lg in _head_logits(medusa_params, params, hidden, dtype)],
        dim=-2,
    )


def valid_target_mask(tokens, eot: int):
    """(B, T) bool: the positions that are training targets, up to and
    including the first EOT (heads must learn to predict the end); only
    the EOT padding past it is excluded."""
    is_eot = (tokens == eot).to(torch.int32)
    return (torch.cumsum(is_eot, dim=1) - is_eot) == 0


def medusa_losses(medusa_params: Dict, params: Dict, cfg: WhisperConfig,
                  hidden, tokens, eot: int, dtype=torch.float32):
    """Mean over heads of each head's masked cross-entropy: head k at
    position t predicts tokens[t + k + 2]; targets past the first EOT are
    masked out. hidden: (B, T, d) teacher-forced decoder hidden states of
    ``tokens`` (B, T). Returns a 0-d float32 tensor."""
    emb = params["decoder"]["token_embedding"].float()
    T = tokens.shape[1]
    after_eot = ~valid_target_mask(tokens, eot)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    with full_fp32():
        for k, head in enumerate(medusa_params["heads"]):
            shift = k + 2
            if shift >= T:
                continue
            hh = _head_hidden(hidden[:, :T - shift].to(dtype), head, dtype)
            logp = torch.log_softmax(hh.float() @ emb.T, dim=-1)
            targets = tokens[:, shift:].long()
            mask = (~after_eot[:, shift:]).to(torch.float32)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
            total = total + (nll * mask).sum() / mask.sum().clamp_min(1)
    return total / max(len(medusa_params["heads"]), 1)


def train_medusa_step(medusa_params: Dict, opt_state, tx, params: Dict,
                      cfg: WhisperConfig, hidden, tokens,
                      eot: int) -> Tuple[Dict, object, torch.Tensor]:
    """One optimizer step on the heads only (the base model frozen).

    ``tx`` is a ``train.optimizer.Optimizer`` over the flat head names
    (``heads.{k}.{w1,...}``); the heads and ``opt_state`` are updated in
    place and returned, with the loss before the step."""
    flat = flatten_params(medusa_params)
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    with torch.enable_grad():
        loss = medusa_losses(unflatten_params(leaves), params, cfg, hidden,
                             tokens, eot)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    tx.step(flat, dict(zip(leaves, grads)), opt_state)
    return medusa_params, opt_state, loss.detach()


def save_medusa(path: str, medusa_params: Dict) -> None:
    """Write the heads as float32 safetensors, ``heads.{k}.{name}``."""
    safetensors_io.save_file(
        {name: t.detach().float().cpu().contiguous()
         for name, t in flatten_params(medusa_params).items()},
        path,
    )


def load_medusa(path: str, device=None) -> Dict:
    """Read a heads file (either package's) onto ``device``."""
    flat = safetensors_io.load_file(path)
    n = 1 + max(int(k.split(".")[1]) for k in flat)
    return {"heads": [
        {name: flat[f"heads.{i}.{name}"].to(device) for name in HEAD_KEYS}
        for i in range(n)
    ]}
