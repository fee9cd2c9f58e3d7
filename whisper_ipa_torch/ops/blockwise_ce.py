"""Blockwise (memory-efficient) cross-entropy over a large vocabulary.

Counterpart of ``whisper_ipa_tpu/ops/blockwise_ce.py`` (a ``lax.scan``
with a custom VJP there, not a Pallas kernel). The tied-embedding logits
product is streamed over vocabulary blocks of ``VOCAB_BLOCK`` rows with an
online log-sum-exp, and the backward recomputes each block, so the
(N, n_vocab) logits never exist: peak memory is O(N * VOCAB_BLOCK).

The reference pads the embedding with zero rows to a whole number of
blocks and masks the padded columns to -inf; here the last block is
simply shorter, which gives the same sums (a masked column adds exp(-inf)
= 0 to every one of them).
"""

from __future__ import annotations

import torch

from .precision import full_fp32

VOCAB_BLOCK = 8192


def _blocks(n_vocab: int):
    for start in range(0, n_vocab, VOCAB_BLOCK):
        yield start, min(start + VOCAB_BLOCK, n_vocab)


def _logsumexp(x, embf):
    """Online log-sum-exp of x @ embf.T over vocabulary blocks: (N,)."""
    m = torch.full((x.shape[0],), float("-inf"), device=x.device)
    s = torch.zeros((x.shape[0],), device=x.device)
    for start, stop in _blocks(embf.shape[0]):
        logits = x @ embf[start:stop].T
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
    return torch.log(s) + m


class _BlockwiseCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, targets, mask):
        with full_fp32():
            xf = x.float()
            embf = emb.float()
            lse = _logsumexp(xf, embf)
            target_logit = (xf * embf[targets]).sum(dim=-1)
        maskf = mask.float()
        num_valid = mask.sum().clamp_min(1).float()
        loss = ((lse - target_logit) * maskf).sum() / num_valid
        ctx.save_for_backward(xf, embf, targets, maskf, lse, num_valid)
        ctx.dtypes = (x.dtype, emb.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        xf, embf, targets, maskf, lse, num_valid = ctx.saved_tensors
        coeff = (g / num_valid) * maskf  # (N,)
        dx = torch.zeros_like(xf)
        demb = torch.empty_like(embf)
        with full_fp32():
            for start, stop in _blocks(embf.shape[0]):
                eb = embf[start:stop]
                # softmax part of dlogits (the one-hot part is added below)
                dl = torch.exp(xf @ eb.T - lse[:, None]) * coeff[:, None]
                dx = dx + dl @ eb
                demb[start:stop] = dl.T @ xf
        dx = dx - coeff[:, None] * embf[targets]
        demb.index_add_(0, targets, -coeff[:, None] * xf)
        x_dtype, emb_dtype = ctx.dtypes
        return dx.to(x_dtype), demb.to(emb_dtype), None, None


def blockwise_cross_entropy(x, emb, targets, mask):
    """Mean masked CE of logits = x @ emb.T without materializing them.

    x: (N, d) float32; emb: (V, d); targets: (N,) int64; mask: (N,) bool.
    Differentiable in x and emb.
    """
    return _BlockwiseCE.apply(x, emb, targets.long(), mask)
