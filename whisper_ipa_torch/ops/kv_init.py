"""Fused cross-attention K/V cache build: the K3 kernel (``csrc/kv_init.cu``)
and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/kv_init.fused_kv_init_int8``: project
the encoder output with a layer's cross K and V weights and quantize the
result to int8 per (position, head), written T-minor for the decode kernels,
in one kernel. The rounding order is that of ``linear`` followed by
``quantize_kv_heads``: f32 accumulation, rounded to the compute dtype, plus
the bias (rounded to that dtype), rounded again, then quantized in f32.
``models/whisper.init_cache`` calls it wherever the bf16 body takes the
call (``bf16_body_takes``), and under ``use_fused_kv_init(True)`` elsewhere,
writing each layer into its views of the stacked cache (``out=``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .precision import div_ieee


def quantize_kv_heads(x, n_head: int):
    """Symmetric int8 per-(position, head) quantization, T-minor layout.

    (B, T, d) -> codes (B, H, Dh, T_pad) int8, scales (B, H, T_pad) f32:
    scale = max(amax over Dh, 1e-8) / 127, codes rounded half to even, T
    padded to a multiple of 128 with code 0 and scale 0.
    """
    B, T, d = x.shape
    dh = d // n_head
    xf = x.transpose(1, 2).float().reshape(B, n_head, dh, T)
    amax = xf.abs().amax(dim=2)  # (B, H, T)
    scale = div_ieee(torch.clamp_min(amax, 1e-8), 127.0)
    codes = torch.round(xf / scale[:, :, None, :]).to(torch.int8)
    t_pad = ((T + 127) // 128) * 128
    if t_pad != T:
        codes = F.pad(codes, (0, t_pad - T))
        scale = F.pad(scale, (0, t_pad - T))
    return codes.contiguous(), scale.contiguous()


def _bias_f32(b, d: int, dtype, device):
    """The bias rounded to the compute dtype, carried in f32 (zeros if
    absent: Whisper's K projection has none)."""
    if b is None:
        return torch.zeros(d, dtype=torch.float32, device=device)
    return b.to(dtype).float().contiguous()


def fused_kv_init_plain(x, wk, bk, wv, bv, n_head: int, out_dtype):
    """Plain PyTorch K3: the same rounding order, with ordinary products."""
    xd = x.to(out_dtype).float()
    outs = []
    for w, b in ((wk, bk), (wv, bv)):
        y = (xd @ w.to(out_dtype).float()).to(out_dtype).float()
        y = (y + _bias_f32(b, w.shape[1], out_dtype, x.device)).to(out_dtype)
        outs.extend(quantize_kv_heads(y, n_head))
    return tuple(outs)


def bf16_body_takes(x, d: int, n_head: int, out_dtype) -> bool:
    """Whether K3's bf16 body takes x (B, T, d_in) projected to d columns
    in n_head heads: a CUDA tensor, bf16, head dim 32 or 64, d_in (its
    k-tile) and d (its weight box) multiples of 64."""
    return (x.device.type == "cuda" and out_dtype == torch.bfloat16
            and d % n_head == 0 and d // n_head in (32, 64)
            and x.shape[-1] % 64 == 0 and d % 64 == 0)


def _check_out(out, shapes, device):
    """The caller's (k_codes, k_scale, v_codes, v_scale): contiguous, of
    the build's shapes and dtypes, on x's device."""
    if len(out) != 4:
        raise ValueError("out must be (k_codes, k_scale, v_codes, v_scale)")
    for t, (shape, dtype) in zip(out, shapes):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"out tensors must be contiguous {shape} {dtype} "
                             f"on {device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def fused_kv_init_int8(x, wk, bk, wv, bv, n_head: int,
                       out_dtype=torch.bfloat16, out=None):
    """K3 wrapper: x (B, T, d_in), wk/wv (d_in, d), bk/bv (d,) or None ->
    (k_codes, k_scale, v_codes, v_scale): codes (B, H, Dh, T_pad) int8,
    scales (B, H, T_pad) f32, T_pad the 128 round-up, code 0 and scale 0
    past T. With ``out`` (four such tensors, e.g. one layer's views of a
    stacked cache) the build is written there and ``out`` returned.

    CUDA tensors run the kernel (bf16: TMA and wgmma; f32: the CUDA
    cores), CPU tensors the plain version.
    """
    B, T, d_in = x.shape
    d = wk.shape[1]
    if wk.shape != (d_in, d) or wv.shape != (d_in, d) or d % n_head:
        raise ValueError(f"weights must be ({d_in}, d) with d % {n_head} == 0")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    dh = d // n_head
    t_pad = ((T + 127) // 128) * 128
    shapes = [((B, n_head, dh, t_pad), torch.int8), ((B, n_head, t_pad), torch.float32)] * 2
    if out is not None:
        _check_out(out, shapes, x.device)
    if x.device.type == "cpu":
        built = fused_kv_init_plain(x, wk, bk, wv, bv, n_head, out_dtype)
        if out is None:
            return built
        for o, t in zip(out, built):
            o.copy_(t)
        return tuple(out)
    if any(t is not None and t.device != x.device for t in (wk, bk, wv, bv)):
        raise ValueError("all operands must be on one CUDA device")
    if out_dtype == torch.bfloat16:
        if not bf16_body_takes(x, d, n_head, out_dtype):
            raise ValueError(f"head dim {dh} (32 or 64), d_in {d_in} and d {d} "
                             f"(multiples of 64) not supported")
    elif dh not in (32, 64) or d_in % 32:
        raise ValueError(f"head dim {dh} (32 or 64) and d_in {d_in} (a "
                         f"multiple of 32) not supported")
    if out is None:
        out = tuple(torch.empty(shape, dtype=dtype, device=x.device)
                    for shape, dtype in shapes)
    xc = x.to(out_dtype).contiguous()
    # the weights as stored, (d_in, d); the bf16 body reads them MN-major
    wkc, wvc = (w.to(out_dtype).contiguous() for w in (wk, wv))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if out_dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (xc, wkc, wvc, out[0], out[2])):
            raise ValueError("the bf16 kernel moves 16-byte chunks: x, the "
                             "weights and the codes must be 16-byte aligned")
        biases = [None if b is None else b.to(out_dtype).contiguous()
                  for b in (bk, bv)]
        fn = _build.entry("kv_init", "wipa_kv_init_bf16",
                          [_build.P] * 9 + [_build.I] * 7 + [_build.P])
        rc = fn(xc.data_ptr(), wkc.data_ptr(), wvc.data_ptr(),
                *(0 if b is None else b.data_ptr() for b in biases),
                *(t.data_ptr() for t in out), B, T, t_pad, d_in, n_head, dh,
                x.device.index, stream)
        _build.check(rc, "wipa_kv_init_bf16")
    else:
        bkc = _bias_f32(bk, d, out_dtype, x.device)
        bvc = _bias_f32(bv, d, out_dtype, x.device)
        fn = _build.entry("kv_init", "wipa_kv_init_f32",
                          [_build.P] * 9 + [_build.I] * 7 + [_build.P])
        rc = fn(xc.data_ptr(), wkc.data_ptr(), bkc.data_ptr(), wvc.data_ptr(),
                bvc.data_ptr(), *(t.data_ptr() for t in out), B, T, t_pad,
                d_in, n_head, dh, x.device.index, stream)
        _build.check(rc, "wipa_kv_init_f32")
    fused_kv_init_int8.launches += 1
    return tuple(out)


fused_kv_init_int8.launches = 0
