"""Fused cross-attention K/V cache build: the K3 kernel (``csrc/kv_init.cu``)
and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/kv_init.fused_kv_init_int8``: project
the encoder output with a layer's cross K and V weights and quantize the
result to int8 per (position, head), written T-minor for the decode kernels,
in one kernel. The rounding order is that of ``linear`` followed by
``quantize_kv_heads``: f32 accumulation, rounded to the compute dtype, plus
the bias (rounded to that dtype), rounded again, then quantized in f32.
``models/whisper.init_cache`` calls it under ``use_fused_kv_init(True)``.
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


def fused_kv_init_int8(x, wk, bk, wv, bv, n_head: int,
                       out_dtype=torch.bfloat16):
    """K3 wrapper: x (B, T, d_in), wk/wv (d_in, d), bk/bv (d,) or None ->
    (k_codes, k_scale, v_codes, v_scale): codes (B, H, Dh, T_pad) int8,
    scales (B, H, T_pad) f32, T_pad the 128 round-up, code 0 and scale 0
    past T.

    CUDA tensors run the kernel (bf16: wgmma products; f32: the CUDA
    cores), CPU tensors the plain version.
    """
    B, T, d_in = x.shape
    d = wk.shape[1]
    if wk.shape != (d_in, d) or wv.shape != (d_in, d) or d % n_head:
        raise ValueError(f"weights must be ({d_in}, d) with d % {n_head} == 0")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if x.device.type == "cpu":
        return fused_kv_init_plain(x, wk, bk, wv, bv, n_head, out_dtype)
    if any(t is not None and t.device != x.device for t in (wk, bk, wv, bv)):
        raise ValueError("all operands must be on one CUDA device")
    dh = d // n_head
    # the bf16 body multiplies 64-feature k-tiles, the f32 body 32-feature
    step = 64 if out_dtype == torch.bfloat16 else 32
    if dh not in (32, 64) or d_in % step:
        raise ValueError(f"head dim {dh} (32 or 64) and d_in {d_in} (a "
                         f"multiple of {step}) not supported")
    t_pad = ((T + 127) // 128) * 128
    xc = x.to(out_dtype).contiguous()
    wkc = wk.to(out_dtype).contiguous()
    wvc = wv.to(out_dtype).contiguous()
    if out_dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (xc, wkc, wvc)):
        raise ValueError("the bf16 kernel copies 16-byte chunks: x, wk and wv "
                         "must be 16-byte aligned")
    bkc = _bias_f32(bk, d, out_dtype, x.device)
    bvc = _bias_f32(bv, d, out_dtype, x.device)
    codes = [torch.empty((B, n_head, dh, t_pad), dtype=torch.int8,
                         device=x.device) for _ in range(2)]
    scales = [torch.empty((B, n_head, t_pad), dtype=torch.float32,
                          device=x.device) for _ in range(2)]
    fn = _build.entry("kv_init", "wipa_kv_init_int8",
                      [_build.P] * 9 + [_build.I] * 8 + [_build.P])
    rc = fn(xc.data_ptr(), wkc.data_ptr(), bkc.data_ptr(), wvc.data_ptr(),
            bvc.data_ptr(), codes[0].data_ptr(), scales[0].data_ptr(),
            codes[1].data_ptr(), scales[1].data_ptr(), B, T, t_pad, d_in,
            n_head, dh, int(out_dtype == torch.bfloat16), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "wipa_kv_init_int8")
    fused_kv_init_int8.launches += 1
    return codes[0], scales[0], codes[1], scales[1]


fused_kv_init_int8.launches = 0
