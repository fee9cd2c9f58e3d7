"""Unmasked attention: the K2 forward (``csrc/attention.cu``) and K5
backward (``csrc/attention_bwd.cu``) kernels, K10 (K2 with head-merged
I/O, ``csrc/attention.cu``), and their plain versions.

Counterpart of ``whisper_ipa_tpu/ops/attention.fused_attention``, a
``jax.custom_vjp`` whose forward and backward are Pallas kernels. Here it
is a ``torch.autograd.Function``: when autograd needs a gradient the K2
forward also writes each row's log-sum-exp, the Function saves q, k, v,
the output and that LSE, and the backward runs K5. Without a gradient
(inference, the frozen encoder under ``torch.no_grad``) the forward is K2
alone. ``models/layers.multi_head_attention`` sends the encoder's
self-attention here under the reference's policy: no mask, bf16 q, at
least 128 queries, on CUDA.

``fused_attention_merged`` is the counterpart of the reference's
``fused_attention_merged``: q, k, v and the output stay (B, T, H*Dh), and
K10 reads each head's columns through the row stride, so no split or merge
copy is made. Its backward runs K5 on split-head copies and merges the
gradients, as the reference does. ``models/layers.multi_head_attention``
sends eligible calls to it under ``use_merged_attention(True)``.

CPU tensors run the plain versions, ``attention_plain`` (and
``attention_merged_plain``) forward and ``attention_backward_plain``
backward; CUDA tensors run the kernels or raise. In bf16 the kernels run
on the tensor cores (K2/K10 on ``wgmma``, K5 on ``mma.sync``) and round
the probabilities (and, backward, dS) to bf16 before their products, as
the plain versions do; f32 runs fp32 products on the CUDA cores. Every
operand must start on a 16-byte boundary.
"""

from __future__ import annotations

import torch

from . import _build


def attention_plain(q, k, v, scale: float = 1.0):
    """Plain PyTorch K2, the counterpart of ``_xla_attention``.

    (BH..., Tq, Dh) x (BH..., Tk, Dh) -> (BH..., Tq, Dh); the scale is
    applied to q in its own dtype, logits and softmax are f32, and the
    probabilities are cast back to v's dtype for the value product. Both
    products sum in f32 over operands in the input dtype, as the TPU
    kernel's (``preferred_element_type=float32``) and the CUDA kernels' do:
    a bf16 matmul would round the logits themselves to bf16.
    """
    dt = v.dtype
    if scale != 1.0:
        q = q * scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(w.float(), v.float()).to(dt)


def attention_backward_plain(q, k, v, g, scale: float = 1.0):
    """Plain PyTorch K5: (dq, dk, dv) of ``attention_plain`` at output
    gradient g, from the recomputed softmax.

    The same identities as the kernel: P = softmax(scale q k^T) in f32,
    dV = P^T g, dP = g v^T, dS = P (dP - rowsum(P dP)), dQ = scale dS k,
    dK = dS^T (scale q). P and dS are rounded to the input dtype before
    their products, as the forward rounds P before its value product;
    every product sums in f32 (a bf16 matmul may reduce partial sums in
    bf16, which loses more than the rounding of its operands).
    """
    dt = q.dtype

    def mm(a, b):
        return torch.matmul(a.to(dt).float(), b.to(dt).float())

    qs = q * scale if scale != 1.0 else q
    p = torch.softmax(mm(qs, k.transpose(-1, -2)), dim=-1)
    dv = mm(p.transpose(-1, -2), g).to(dt)
    dp = mm(g, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (mm(ds, k) * scale).to(dt)
    dk = mm(ds.transpose(-1, -2), qs).to(dt)
    return dq, dk, dv


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or (
        q.shape[-1] != k.shape[-1]
    ):
        raise ValueError(
            f"fused_attention wants (B, H, T, Dh) q/k/v, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError("fused_attention wants one dtype, f32 or bf16")
    if q.device.type not in ("cpu", "cuda") or k.device != q.device or (
        v.device != q.device
    ):
        raise ValueError(f"unsupported devices {q.device}, {k.device}, {v.device}")
    if q.device.type == "cuda":
        if q.shape[-1] not in (32, 64):
            raise ValueError(f"head dim {q.shape[-1]} not supported (32 or 64)")
        if k.shape[2] < 1 or q.shape[2] < 1:
            raise ValueError("fused_attention needs at least one query and key")


def _check_aligned(*tensors) -> None:
    """The kernels copy 16-byte chunks (cp.async): raise, and do not copy,
    on an operand whose data does not start on a 16-byte boundary (a view
    at an odd storage offset, which ``.contiguous()`` leaves as it is)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"attention kernels need 16-byte aligned operands, got a "
                f"{t.dtype} tensor at storage offset {t.storage_offset()}"
            )


def _forward_kernel(q, k, v, scale: float, with_lse: bool):
    """Launch K2 on contiguous CUDA q/k/v; returns (out, lse or None)."""
    _check_aligned(q, k, v)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    out = torch.empty_like(q)
    lse = (
        torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        if with_lse else None
    )
    fn = _build.entry(
        "attention",
        "wipa_attention_fwd",
        [_build.P, _build.P, _build.P, _build.P, _build.P, _build.I,
         _build.I, _build.I, _build.I, _build.I, _build.F32, _build.I,
         _build.P],
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        B * H, Tq, Tk, Dh, int(q.dtype == torch.bfloat16), float(scale),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wipa_attention_fwd")
    fused_attention.launches += 1
    return out, lse


def attention_backward(q, k, v, out, g, lse, scale: float = 1.0):
    """K5 wrapper: (dq, dk, dv) from the forward's q, k, v, out and its
    per-row log-sum-exp ``lse`` (B, H, Tq) f32, at output gradient g.

    All of q, k, v, out, g share one dtype (f32 or bf16). CPU tensors run
    ``attention_backward_plain``, which recomputes the softmax and needs
    neither ``out`` nor ``lse`` (either may be None there).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, g, scale)
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype or (
        g.dtype != q.dtype
    ):
        raise ValueError("out and g must have q's shape and dtype")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, H, Tq) float32")
    if any(t.device != q.device for t in (out, g, lse)):
        raise ValueError("all inputs must be on one device")
    q, k, v, out, g, lse = (
        t.contiguous() for t in (q, k, v, out, g, lse)
    )
    _check_aligned(q, k, v, out, g)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    fn = _build.entry(
        "attention_bwd",
        "wipa_attention_bwd",
        [_build.P] * 10
        + [_build.I, _build.I, _build.I, _build.I, _build.I, _build.F32,
           _build.I, _build.P],
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        B * H, Tq, Tk, Dh, int(q.dtype == torch.bfloat16), float(scale),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wipa_attention_bwd")
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class _FusedAttention(torch.autograd.Function):
    """Forward K2 (with the LSE residual), backward K5; on the CPU the two
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, scale), None
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, g, lse, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q, k, v, scale: float = 1.0):
    """(B, H, Tq, Dh) x (B, H, Tk, Dh) -> (B, H, Tq, Dh), no mask;
    differentiable.

    CUDA tensors run the flash-style K2 kernel (bf16 or f32, Dh 32 or 64)
    and, under autograd, K5 for the gradient; CPU tensors run the plain
    versions.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FusedAttention.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    out, _ = _forward_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), scale, with_lse=False
    )
    return out


fused_attention.launches = 0


# -- K10: head-merged I/O ---------------------------------------------------

# models/layers imports this module, so its split_heads/merge_heads are
# repeated here rather than imported
def _split(x, n_head: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention_merged_plain(q, k, v, n_head: int, scale: float = 1.0):
    """Plain PyTorch K10: ``attention_plain`` over the heads of (B, T, d)
    operands, (B, Tq, d) out."""
    return _merge(attention_plain(_split(q, n_head), _split(k, n_head),
                                  _split(v, n_head), scale))


def _check_merged(q, k, v, n_head: int) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or (
        q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]
    ) or q.shape[2] % n_head:
        raise ValueError(
            f"fused_attention_merged wants (B, T, d) q/k/v with d % {n_head} "
            f"== 0, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    _check(_split(q, n_head), _split(k, n_head), _split(v, n_head))


def _merged_forward_kernel(q, k, v, n_head: int, scale: float, with_lse: bool):
    """Launch K10 on contiguous CUDA (B, T, d) q/k/v; returns (out, lse
    (B, H, Tq) f32 or None)."""
    _check_aligned(q, k, v)
    B, Tq, d = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse = (
        torch.empty((B, n_head, Tq), dtype=torch.float32, device=q.device)
        if with_lse else None
    )
    fn = _build.entry(
        "attention",
        "wipa_attention_merged_fwd",
        [_build.P, _build.P, _build.P, _build.P, _build.P, _build.I,
         _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32,
         _build.I, _build.P],
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        B, n_head, Tq, Tk, d // n_head, int(q.dtype == torch.bfloat16),
        float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wipa_attention_merged_fwd")
    fused_attention_merged.launches += 1
    return out, lse


class _FusedAttentionMerged(torch.autograd.Function):
    """Forward K10 (with the LSE residual), backward K5 on split heads; on
    the CPU the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, n_head, scale):
        ctx.n_head, ctx.scale = n_head, scale
        if q.device.type == "cpu":
            out, lse = attention_merged_plain(q, k, v, n_head, scale), None
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _merged_forward_kernel(q, k, v, n_head, scale,
                                              with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        n = ctx.n_head
        dq, dk, dv = attention_backward(
            *(_split(t, n).contiguous() for t in (q, k, v, out, g)), lse,
            ctx.scale,
        )
        return _merge(dq), _merge(dk), _merge(dv), None, None


def fused_attention_merged(q, k, v, n_head: int, scale: float = 1.0):
    """(B, Tq, d) x (B, Tk, d) -> (B, Tq, d), d = n_head * Dh, no mask;
    differentiable.

    CUDA tensors run K10 (bf16 or f32, Dh 32 or 64) and, under autograd,
    K5 on split heads for the gradient; CPU tensors run the plain versions.
    """
    _check_merged(q, k, v, n_head)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FusedAttentionMerged.apply(q, k, v, int(n_head), float(scale))
    if q.device.type == "cpu":
        return attention_merged_plain(q, k, v, n_head, scale)
    out, _ = _merged_forward_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), n_head, scale,
        with_lse=False,
    )
    return out


fused_attention_merged.launches = 0
