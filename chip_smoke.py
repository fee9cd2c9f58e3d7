#!/usr/bin/env python3
"""Smoke test of the PyTorch port (whisper_ipa_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the hand-written kernels from whisper_ipa_torch/csrc, holds each
against its plain PyTorch version at its path's shapes (and times one
PyTorch library call that computes the same function, where there is one),
then drives the port's two paths at whisper-small width with random
weights from seed 0:

  serving   waveform -> log-mel (K1) -> encoder (K2) -> int8 cross-KV
            greedy decode (K4), batch 16; CUDA against the CPU; the
            micro-batching service
  quantized serving, the same batch three more ways: the int8 cross cache
            built by the fused kernel (K3); int8 weights with int8
            activations (K6); int4 weights (K7) with the int4 cross cache
            (K8); test-tiny CUDA against the CPU for int8 and int4; the
            service with int4 weights and cache
  training  train() on a seeded synthetic set, batch 12, bf16
            activations: decoder-only (encoder frozen, K2 forward only)
            and --unfreeze-encoder (K2 forward, K5 backward); save and
            resume on the card; a test-tiny trajectory on CUDA against
            the CPU

Each path's kernel launch counts are set to 0 just before it and read just
after. Any failure raises and exits non-zero; there is no CPU fallback.
The last three lines are a JSON summary of the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

SAMPLE_RATE = 16000
MAIN_BATCH = 16
MAIN_SAMPLE_LEN = 64
TRAIN_BATCH = 12
TRAIN_STEPS = 10
TRAIN_LR = 1e-4  # ten times the default: overfit one fixed batch quickly

# The H100 SXM's published peaks (dense) at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(n_bytes: float, n_flops: float, flop_type: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[flop_type] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -- phases -----------------------------------------------------------------

def phase_environment(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, "nvidia-smi runs")
    card = smi.stdout.strip().splitlines()[0]
    from whisper_ipa_torch.ops import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        timeout=60,
    )
    try:
        import regex  # noqa: F401  (the tokenizer's pre-tokenizer)

        has_regex = True
    except ImportError:
        has_regex = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"({torch.cuda.get_device_name(0)})")
    log(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[env] regex importable: {has_regex}")
    return card


def phase_build():
    from whisper_ipa_torch.ops import _build

    t0 = time.time()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built with nvcc for sm_90a in "
        f"{time.time() - t0:.1f} s: "
        + ", ".join(p.name for p in paths.values()))


def check_mel(torch, dev):
    from whisper_ipa_torch.audio import log_mel_spectrogram as numpy_log_mel
    from whisper_ipa_torch.ops import mel_kernel as mk

    rng = np.random.default_rng(0)
    t = np.arange(30 * SAMPLE_RATE) / SAMPLE_RATE
    audio = (0.1 * rng.standard_normal((MAIN_BATCH, t.size))
             + 0.3 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    padded = mk.reflect_pad(torch.from_numpy(audio).to(dev)).contiguous()
    entry = None
    for n_mels in (80, 128):
        before = mk.log_mel_power.launches
        got = mk.normalize(mk.log_mel_power(padded, n_mels))
        torch.cuda.synchronize()
        require(mk.log_mel_power.launches == before + 1, "K1 counter rose")
        want = mk.normalize(mk.log_mel_power_plain(padded, n_mels))
        require(got.shape == (MAIN_BATCH, 3000, n_mels),
                f"K1 shape {tuple(got.shape)}")
        err = max_abs(got, want)
        err_np = float(np.abs(got[0].cpu().numpy()
                              - numpy_log_mel(audio[0], n_mels=n_mels)).max())
        ms = cuda_ms(lambda: mk.log_mel_power(padded, n_mels))
        plain_ms = cuda_ms(lambda: mk.log_mel_power_plain(padded, n_mels))
        log(f"[K1 mel] n_mels={n_mels} audio ({MAIN_BATCH}, 480000): "
            f"max|kernel-plain| "
            f"{err:.3e}, max|kernel-numpy| row 0 {err_np:.3e} (bound 5e-4); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(err < 5e-4 and err_np < 5e-4, f"K1 n_mels={n_mels} within 5e-4")
        if n_mels == 80:
            cos_b, sin_b, mel_t = mk._operators(n_mels, dev)
            frames = got.shape[0] * got.shape[1]
            # the kernel's DFT as two (400 x 201) products, the power
            # spectrum, the (201 x n_mels) mel product, per frame, in fp32
            flops = frames * (2 * 2 * 400 * 201 + 3 * 201 + 2 * 201 * n_mels)
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(padded, cos_b, sin_b, mel_t, got),
                                 flops, "fp32"),
                         library_ms=None)
    return entry


def check_attention(torch, dev):
    from whisper_ipa_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    entry = None
    # bounds: f32 2e-5 (the TPU kernel's test bound); bf16 2e-2 absolute at
    # unit-normal inputs: the plain version rounds its logits and
    # probabilities to bf16, the kernel keeps them in f32
    for dh, dtype, tol in (
        (64, torch.bfloat16, 2e-2),
        (64, torch.float32, 2e-5),
        (32, torch.bfloat16, 2e-2),
        (32, torch.float32, 2e-5),
    ):
        q, k, v = (
            torch.randn((MAIN_BATCH, 12, 1500, dh), generator=gen,
                        device=dev).to(dtype)
            for _ in range(3)
        )
        scale = dh ** -0.5
        before = at.fused_attention.launches
        got = at.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        require(at.fused_attention.launches == before + 1, "K2 counter rose")
        want = at.attention_plain(q, k, v, scale)
        require(got.shape == want.shape and got.dtype == dtype, "K2 shape/dtype")
        err = max_abs(got, want)
        exact = at.attention_plain(q.float(), k.float(), v.float(), scale)
        ms = cuda_ms(lambda: at.fused_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: at.attention_plain(q, k, v, scale))
        log(f"[K2 attention] ({MAIN_BATCH}*12, 1500, {dh}) {str(dtype)[6:]}: "
            f"max|kernel-plain| {err:.3e} (bound {tol:g}); vs f32 on the "
            f"same inputs: kernel {max_abs(got, exact):.3e}, plain "
            f"{max_abs(want, exact):.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(err < tol, f"K2 dh={dh} {dtype} within {tol}")
        if entry is None:
            bh, tq, tk = q.shape[0] * q.shape[1], q.shape[2], k.shape[2]
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q, k, v, scale=scale))
            log(f"[K2 attention] library: scaled_dot_product_attention "
                f"forward {lib_ms:.4f} ms on the same inputs")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(q, k, v, got), 4 * bh * tq * tk * dh,
                                 "bf16"),
                         library_ms=lib_ms)
    return entry


def check_decode_attention(torch, dev):
    from whisper_ipa_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, Dh, T, T_pad = MAIN_BATCH, 12, 64, 1500, 1536

    def codes():
        c = torch.randint(-127, 128, (B, H, Dh, T_pad), generator=gen, device=dev)
        return c.to(torch.int8).contiguous()

    def scales():
        s = 0.01 + 0.02 * torch.rand((B, H, T_pad), generator=gen, device=dev)
        s[..., T:] = 0.0  # padded positions
        return s.contiguous()

    k, ks, v, vs = codes(), scales(), codes(), scales()
    q32 = torch.randn((B, H, 1, Dh), generator=gen, device=dev) * Dh ** -0.5
    entry = None
    # bounds: f32 rtol/atol 1e-5; bf16 q 2% of the largest output: the plain
    # version rounds its logits and weighted probabilities to bf16
    for dtype in (torch.bfloat16, torch.float32):
        q = q32.to(dtype)
        before = da.decode_cross_attention_int8_tminor.launches
        got = da.decode_cross_attention_int8_tminor(q, k, ks, v, vs)
        torch.cuda.synchronize()
        require(
            da.decode_cross_attention_int8_tminor.launches == before + 1,
            "K4 counter rose",
        )
        want = da.decode_attention_plain(q, k, ks, v, vs)
        require(got.shape == (B, H, 1, Dh) and got.dtype == dtype, "K4 shape/dtype")
        err = max_abs(got, want)
        scale = float(want.float().abs().max())
        if dtype == torch.float32:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            tol = "rtol=atol=1e-5"
        else:
            ok = err <= 0.02 * scale
            tol = f"2% of max|out| = {0.02 * scale:.3e}"
        exact = da.decode_attention_plain(q.float(), k, ks, v, vs)
        ms = cuda_ms(lambda: da.decode_cross_attention_int8_tminor(q, k, ks, v, vs))
        plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, k, ks, v, vs))
        log(f"[K4 decode attention] B={B} H=12 Dh=64 T_pad=1536 (scale 0 from "
            f"1500) q {str(dtype)[6:]}: max|kernel-plain| {err:.3e} "
            f"({tol}); vs f32 on the same inputs: kernel "
            f"{max_abs(got, exact):.3e}, plain {max_abs(want, exact):.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(ok, f"K4 q {dtype} within bound")
        if entry is None:
            # q.k over every cached position and p.v back, 2 flops a MAC
            flops = 4 * B * H * Dh * T_pad
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(q, k, ks, v, vs, got), flops, "bf16"),
                         library_ms=None)
    return entry


def check_attention_backward(torch, dev):
    from whisper_ipa_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, T = TRAIN_BATCH, 12, 1500
    entry = None
    # bounds, relative to max|grad|: f32 1e-4 (the CPU tests hold the plain
    # version to the TPU kernel at 1e-5; here the kernel sums 1500 terms in
    # another order than cuBLAS); bf16 2%: the plain version rounds P and dS
    # to bf16 before its products, the kernel keeps them in f32
    for dh, dtype, tol in (
        (64, torch.bfloat16, 2e-2),
        (64, torch.float32, 1e-4),
        (32, torch.bfloat16, 2e-2),
        (32, torch.float32, 1e-4),
    ):
        q, k, v, g = (
            torch.randn((B, H, T, dh), generator=gen, device=dev).to(dtype)
            for _ in range(4)
        )
        scale = dh ** -0.5
        out, lse = at._forward_kernel(q, k, v, scale, with_lse=True)
        before = at.attention_backward.launches
        got = at.attention_backward(q, k, v, out, g, lse, scale)
        torch.cuda.synchronize()
        require(at.attention_backward.launches == before + 1, "K5 counter rose")
        want = at.attention_backward_plain(q, k, v, g, scale)
        exact = at.attention_backward_plain(q.float(), k.float(), v.float(),
                                            g.float(), scale)
        rel = [max_abs(a, b) / float(b.float().abs().max())
               for a, b in zip(got, want)]
        rel_k = [max_abs(a, e) / float(e.abs().max()) for a, e in zip(got, exact)]
        rel_p = [max_abs(a, e) / float(e.abs().max()) for a, e in zip(want, exact)]
        ms = cuda_ms(lambda: at.attention_backward(q, k, v, out, g, lse, scale))
        plain_ms = cuda_ms(lambda: at.attention_backward_plain(q, k, v, g, scale))
        fmt = lambda xs: "/".join(f"{x:.2e}" for x in xs)  # noqa: E731
        log(f"[K5 attention backward] ({B}*{H}, {T}, {dh}) {str(dtype)[6:]}: "
            f"max|kernel-plain|/max|plain| dq/dk/dv {fmt(rel)} (bound {tol:g}); "
            f"vs f32 on the same inputs: kernel {fmt(rel_k)}, plain "
            f"{fmt(rel_p)}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(max(rel) < tol, f"K5 dh={dh} {dtype} within {tol}")
        if entry is None:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def fwd_bwd(fn):
                o = fn(qg, kg, vg, scale=scale)
                return torch.autograd.grad(o, (qg, kg, vg), g)

            lib_ms = cuda_ms(lambda: fwd_bwd(
                torch.nn.functional.scaled_dot_product_attention))
            ours_ms = cuda_ms(lambda: fwd_bwd(at.fused_attention))
            log(f"[K5 attention backward] forward + backward on the same "
                f"inputs: library scaled_dot_product_attention {lib_ms:.4f} ms, "
                f"the port's K2 + K5 {ours_ms:.4f} ms")
            bh = B * H
            # recomputed S = q k^T, dV = P^T g, dP = g v^T, dQ = dS k,
            # dK = dS^T q: five (T x T x Dh) products, 2 flops a MAC
            entry = dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                         ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(q, k, v, out, g, lse, *got),
                                 10 * bh * T * T * dh, "bf16"),
                         library_ms=lib_ms)
    return entry


def rel_err(a, b) -> float:
    """max|a - b| over max|b|."""
    return max_abs(a, b) / float(b.float().abs().max())


def check_kv_init(torch, dev):
    from whisper_ipa_torch.models.layers import linear
    from whisper_ipa_torch.ops import kv_init as kv

    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, d, H = MAIN_BATCH, 1500, 768, 12
    x = 0.5 * torch.randn((B, T, d), generator=gen, device=dev)
    wk, wv = (0.05 * torch.randn((d, d), generator=gen, device=dev)
              for _ in range(2))
    b = 0.1 * torch.randn((d,), generator=gen, device=dev)
    entry = None
    # bounds: codes >= 99.9% equal, within 1 where the (position, head)
    # scale is the same and 2 where the head's maximum itself rounded the
    # other way (cuBLAS sums the projection in another order, so a bf16
    # rounding may flip); scales 2^-7 relative in bf16 (one ulp of the
    # head's maximum), 2^-6 in bf16 with the V bias (one ulp of the
    # projection plus the bias add's rounding: two ulps of a sum that the
    # bias made smaller), 1e-5 in f32
    for dtype, bias in ((torch.bfloat16, None), (torch.bfloat16, b),
                        (torch.float32, b)):
        xd, wkd, wvd = x.to(dtype), wk.to(dtype), wv.to(dtype)
        args = (xd, wkd, None, wvd, bias, H)
        before = kv.fused_kv_init_int8.launches
        got = kv.fused_kv_init_int8(*args, out_dtype=dtype)
        torch.cuda.synchronize()
        require(kv.fused_kv_init_int8.launches == before + 1, "K3 counter rose")
        want = kv.fused_kv_init_plain(*args, dtype)
        if dtype == torch.bfloat16:
            tol = 2 ** -7 if bias is None else 2 ** -6
        else:
            tol = 1e-5
        code_ok, equal, worst, scale_rel = True, [], 0, 0.0
        for i in (0, 2):
            require(got[i].shape == (B, H, 64, 1536), f"K3 shape {tuple(got[i].shape)}")
            diff = (got[i].int() - want[i].int()).abs()
            same = (got[i + 1] == want[i + 1])[:, :, None, :]
            code_ok &= bool((diff <= torch.where(same, 1, 2)).all())
            equal.append(float((diff == 0).float().mean()))
            worst = max(worst, int(diff.max()))
            scale_rel = max(scale_rel, float(((got[i + 1] - want[i + 1]).abs()
                                              / want[i + 1].clamp_min(1e-30)).max()))
            require(bool((got[i][..., T:] == 0).all())
                    and bool((got[i + 1][..., T:] == 0).all())
                    and bool((got[i + 1][..., :T] > 0).all()),
                    "K3 tail code 0 and scale 0")
        ms = cuda_ms(lambda: kv.fused_kv_init_int8(*args, out_dtype=dtype))
        plain_ms = cuda_ms(lambda: kv.fused_kv_init_plain(*args, dtype))
        log(f"[K3 kv init] x ({B}, {T}, {d}) {str(dtype)[6:]}, H {H}, V bias "
            f"{bias is not None}: codes equal {min(equal):.5f}, max|diff| "
            f"{worst} (scale-aware bound 1/2), scales max relative "
            f"{scale_rel:.3e} (bound {tol:g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        require(code_ok and min(equal) >= 0.999 and scale_rel <= tol,
                f"K3 {dtype} bias {bias is not None} within bounds")
        if entry is None:
            def unfused():  # what init_cache runs without the switch
                return [kv.quantize_kv_heads(linear(xd, {"w": w, "b": bb}), H)
                        for w, bb in ((wkd, None), (wvd, bias))]

            lib_ms = cuda_ms(unfused)
            log(f"[K3 kv init] library: unfused torch.matmul (cuBLAS) + the "
                f"plain quantizer {lib_ms:.4f} ms on the same inputs")
            out_bytes = nbytes(*got)
            entry = dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(xd, wkd, wvd) + out_bytes,
                                 2 * 2 * B * T * d * d, "bf16"),
                         library_ms=lib_ms)
    return entry


def check_int8_matmul(torch, dev):
    from whisper_ipa_torch.ops import quant_matmul as qm
    from whisper_ipa_torch.ops.quant import quantize_linear

    gen = torch.Generator(device=dev).manual_seed(0)
    entry = None
    for m, k, n in ((24000, 768, 768), (16, 768, 768), (24000, 3072, 768)):
        q = quantize_linear({"w": 0.05 * torch.randn((k, n), generator=gen,
                                                     device=dev)})
        w_q, w_s = q["w_q"].to(dev), q["w_s"].to(dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        before = qm.int8_matmul.launches
        got = qm.int8_matmul(x, w_q, w_s)
        torch.cuda.synchronize()
        require(qm.int8_matmul.launches == before + 1, "K6 counter rose")
        want = qm.int8_matmul_plain(x, w_q, w_s)
        err = rel_err(got, want)
        ms = cuda_ms(lambda: qm.int8_matmul(x, w_q, w_s))
        plain_ms = cuda_ms(lambda: qm.int8_matmul_plain(x, w_q, w_s))
        lib = ""
        lib_ms = None
        if m > 16:  # cuBLASLt's int8 product wants more than 16 rows
            xf = x.float()
            s = xf.abs().amax(1, keepdim=True).clamp_min(1e-6) / 127
            x_codes = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
            lib_ms = cuda_ms(lambda: torch._int_mm(x_codes, w_q))
            lib = f", library torch._int_mm on the same codes (product alone) {lib_ms:.4f} ms"
        log(f"[K6 int8 matmul] ({m}, {k}) bf16 x ({k}, {n}) int8: "
            f"max|kernel-plain|/max|plain| {err:.3e} (bound 1e-6); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms{lib}")
        require(err <= 1e-6, f"K6 ({m}, {k}, {n}) within 1e-6")
        if entry is None:
            entry = dict(max_abs_err=max_abs(got, want), ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(x, w_q, w_s, got), 2 * m * k * n, "int8"),
                         library_ms=lib_ms)
    return entry


def check_int4_matmul(torch, dev):
    from whisper_ipa_torch.ops import quant_matmul as qm
    from whisper_ipa_torch.ops.quant import quantize_linear_int4

    gen = torch.Generator(device=dev).manual_seed(0)
    entry = None
    for k, n in ((768, 3072), (3072, 768)):
        q = quantize_linear_int4({"w": 0.05 * torch.randn((k, n), generator=gen,
                                                          device=dev)})
        w_q4, w_s4 = q["w_q4"].to(dev), q["w_s4"].to(dev)
        for m in (16, 64):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                before = qm.int4_matmul.launches
                got = qm.int4_matmul(x, w_q4, w_s4)
                torch.cuda.synchronize()
                require(qm.int4_matmul.launches == before + 1, "K7 counter rose")
                want = qm.int4_matmul_plain(x, w_q4, w_s4)
                err = rel_err(got, want)
                ms = cuda_ms(lambda: qm.int4_matmul(x, w_q4, w_s4))
                plain_ms = cuda_ms(lambda: qm.int4_matmul_plain(x, w_q4, w_s4))
                log(f"[K7 int4 matmul] ({m}, {k}) {str(dtype)[6:]} x packed "
                    f"({k // 2}, {n}): max|kernel-plain|/max|plain| {err:.3e} "
                    f"(bound 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                require(err <= 1e-5, f"K7 ({m}, {k}, {n}) {dtype} within 1e-5")
                if entry is None:
                    entry = dict(max_abs_err=max_abs(got, want), ms=ms,
                                 plain_ms=plain_ms,
                                 **bound(nbytes(x, w_q4, w_s4, got),
                                         2 * m * k * n, "fp32"),
                                 library_ms=None)
    return entry


def check_decode_attention_int4(torch, dev):
    from whisper_ipa_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, T, T_pad = MAIN_BATCH, 12, 1500, 1536
    entry = None
    # bounds: f32 q 1e-5 of max|out|; bf16 q 1e-2: the plain version rounds
    # its logits and weighted probabilities to bf16
    for dh in (64, 32):
        def packed():  # any byte is two valid 4-bit codes
            c = torch.randint(-128, 128, (B, H, dh, T_pad // 2), generator=gen,
                              device=dev)
            return c.to(torch.int8).contiguous()

        def scales():
            s = 0.1 + 0.2 * torch.rand((B, H, T_pad), generator=gen, device=dev)
            s[..., T:] = 0.0  # padded positions
            return s.contiguous()

        k, ks, v, vs = packed(), scales(), packed(), scales()
        q32 = torch.randn((B, H, 1, dh), generator=gen, device=dev) * dh ** -0.5
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            q = q32.to(dtype)
            before = da.decode_cross_attention_int4_tminor.launches
            got = da.decode_cross_attention_int4_tminor(q, k, ks, v, vs)
            torch.cuda.synchronize()
            require(da.decode_cross_attention_int4_tminor.launches == before + 1,
                    "K8 counter rose")
            want = da.decode_attention_int4_plain(q, k, ks, v, vs)
            require(got.shape == (B, H, 1, dh) and got.dtype == dtype,
                    "K8 shape/dtype")
            err = rel_err(got, want)
            ms = cuda_ms(lambda: da.decode_cross_attention_int4_tminor(q, k, ks, v, vs))
            plain_ms = cuda_ms(lambda: da.decode_attention_int4_plain(q, k, ks, v, vs))
            log(f"[K8 int4 decode attention] B={B} H={H} Dh={dh} T_pad={T_pad} "
                f"(scale 0 from {T}) q {str(dtype)[6:]}: max|kernel-plain|/"
                f"max|plain| {err:.3e} (bound {tol:g}); kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
            require(err <= tol, f"K8 Dh {dh} q {dtype} within {tol}")
            if entry is None:
                # q.k over every cached position and p.v back, 2 flops a
                # MAC, f32 on the CUDA cores
                entry = dict(max_abs_err=max_abs(got, want), ms=ms,
                             plain_ms=plain_ms,
                             **bound(nbytes(q, k, ks, v, vs, got),
                                     4 * B * H * dh * T_pad, "fp32"),
                             library_ms=None)
    return entry


def counters():
    from whisper_ipa_torch.ops import (attention, decode_attention, kv_init,
                                       mel_kernel, quant_matmul)

    return {
        "K1": mel_kernel.log_mel_power,
        "K2": attention.fused_attention,
        "K3": kv_init.fused_kv_init_int8,
        "K4": decode_attention.decode_cross_attention_int8_tminor,
        "K5": attention.attention_backward,
        "K6": quant_matmul.int8_matmul,
        "K7": quant_matmul.int4_matmul,
        "K8": decode_attention.decode_cross_attention_int4_tminor,
    }


def synthetic_audio(batch: int, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, int(seconds * SAMPLE_RATE))) * 0.1
            ).astype(np.float32)


SERVING_RUNS = 3


def phase_serving_path(torch, dev, cfg, params, tok, name, expect, **opts):
    """One warm-up and SERVING_RUNS timed runs of waveform -> log-mel ->
    decode() at batch 16, 64 tokens a row; each run's launches are counted
    from 0. ``expect`` maps kernels to their launches in one run (None: >
    0). Returns (launches of a run, the last run's results)."""
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    options = DecodingOptions(
        language="en", without_timestamps=True, sample_len=MAIN_SAMPLE_LEN,
        suppress_tokens=[-1, tok.eot],  # every row decodes all 64 tokens
        fp16=True, **opts,
    )
    audio = torch.from_numpy(synthetic_audio(MAIN_BATCH, 30.0, seed=1)).to(dev)

    def run():
        with torch.inference_mode():
            mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
        return mel, decode(params, cfg, mel, options, tokenizer=tok)

    t0 = time.time()
    run()  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    warm = time.time() - t0

    walls, per_run, peaks = [], [], []
    for _ in range(SERVING_RUNS):
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        mel, results = run()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        per_run.append({k: fn.launches for k, fn in counters().items()})
        peaks.append(torch.cuda.max_memory_allocated(dev) / 1e9)

    require(bool(torch.isfinite(mel).all()), "log-mel finite")
    require(len(results) == MAIN_BATCH, "one result per row")
    for r in results:
        require(len(r.tokens) == MAIN_SAMPLE_LEN, f"{len(r.tokens)} tokens")
        # avg_logprob and no_speech_prob are read off the logits
        require(np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob),
                "finite logits")
    require(all(c == per_run[0] for c in per_run), f"{name}: same launches each run")
    launches = {k: c for k, c in per_run[0].items() if c}
    for kernel, want in expect.items():
        got = per_run[0][kernel]
        require(got > 0 if want is None else got == want,
                f"{name}: {kernel} launched {got} times, expected "
                f"{'> 0' if want is None else want}")
    audio_s = MAIN_BATCH * 30.0
    log(f"[{name}] whisper-small bf16, batch {MAIN_BATCH} x 30 s, "
        f"{MAIN_SAMPLE_LEN} tokens/row: walls {[round(w, 4) for w in walls]} s "
        f"({[round(audio_s / w, 1) for w in walls]} audio-s/s); warm-up run "
        f"{warm:.2f} s; peak device memory {[round(p, 2) for p in peaks]} GB; "
        f"launches per run {launches}")
    return per_run[0], results


def phase_quantized_paths(torch, dev, cfg, params, tok, by_path, default_results):
    """The three quantized serving runs of the main path's batch."""
    from whisper_ipa_torch.models import (params_to, use_fused_kv_init,
                                          use_int8_activations)
    from whisper_ipa_torch.ops.quant import quantize_params

    steps = MAIN_SAMPLE_LEN - 1  # single-query steps after the prefix step
    n_dec, n_enc = cfg.n_text_layer, cfg.n_audio_layer
    try:
        use_fused_kv_init(True)
        by_path["serving fused KV init"], fused = phase_serving_path(
            torch, dev, cfg, params, tok, "serving fused KV init",
            {"K1": 1, "K2": n_enc, "K3": n_dec, "K4": steps * n_dec},
            kv_int8=True)
    finally:
        use_fused_kv_init(False)
    same = sum(x == y for a, b in zip(fused, default_results)
               for x, y in zip(a.tokens, b.tokens))
    log(f"[serving fused KV init] {same}/{MAIN_BATCH * MAIN_SAMPLE_LEN} token "
        f"positions equal the default serving run's (informative: random "
        f"weights, near-tie argmaxes)")

    t0 = time.time()
    q8 = params_to(quantize_params(params, bits=8), dev)
    log(f"[quantize] whisper-small int8 on the host in {time.time() - t0:.1f} s")
    try:
        use_int8_activations(True)
        # every int8 linear: 6 an encoder layer, the 2 cross projections a
        # decoder layer in init_cache, 8 a decoder layer a step
        by_path["serving int8"], _ = phase_serving_path(
            torch, dev, cfg, q8, tok, "serving int8",
            {"K1": 1, "K2": n_enc, "K6": 6 * n_enc + 2 * n_dec
             + 8 * n_dec * MAIN_SAMPLE_LEN, "K4": steps * n_dec},
            kv_int8=True)
    finally:
        use_int8_activations(False)
    del q8

    t0 = time.time()
    q4 = params_to(quantize_params(params, bits=4), dev)
    log(f"[quantize] whisper-small int4 on the host in {time.time() - t0:.1f} s")
    # K7 for the decode-shaped linears only (8 a decoder layer a step);
    # the encoder and the cross projections take the half-weight path
    by_path["serving int4"], _ = phase_serving_path(
        torch, dev, cfg, q4, tok, "serving int4",
        {"K1": 1, "K2": n_enc, "K7": 8 * n_dec * MAIN_SAMPLE_LEN, "K3": 0,
         "K6": 0, "K8": steps * n_dec, "K4": 0}, kv_int4=True)
    del q4
    torch.cuda.empty_cache()


def phase_parity(torch, dev, tok):
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.ops import log_mel_spectrogram

    # test-tiny at the shapes of tests/test_decode.py: tokens must match
    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
    cpu_params = init_params(cfg, seed=0)
    gpu_params = params_to(cpu_params, dev)
    mel = np.random.default_rng(0).standard_normal((2, 64, cfg.n_mels)).astype(
        np.float32)
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=16, kv_int8=True)
    k4 = counters()["K4"]
    before = k4.launches
    gpu = decode(gpu_params, cfg, mel, opts, tokenizer=tok)
    require(k4.launches > before, "K4 ran in the test-tiny CUDA decode")
    cpu = decode(cpu_params, cfg, mel, opts, tokenizer=tok)
    same = [a.tokens == b.tokens for a, b in zip(gpu, cpu)]
    log(f"[parity] test-tiny f32 int8 cross-KV, 2 rows x 16 tokens: CUDA == "
        f"CPU tokens per row {same}")
    require(all(same), "test-tiny greedy tokens identical on CUDA and CPU")

    # quantized weights: int8 with the int8 cache (weight-only on both
    # sides), int4 with the int4 cache (K7 and K8 on CUDA, the half-weight
    # and plane paths on the CPU)
    from whisper_ipa_torch.ops.quant import quantize_params

    for bits, kv, kernels in ((8, dict(kv_int8=True), ("K4",)),
                              (4, dict(kv_int4=True), ("K7", "K8"))):
        q_cpu = quantize_params(cpu_params, bits=bits)
        q_gpu = params_to(q_cpu, dev)
        opts = DecodingOptions(language="en", without_timestamps=True,
                               sample_len=16, **kv)
        before = {k: counters()[k].launches for k in kernels}
        gpu = decode(q_gpu, cfg, mel, opts, tokenizer=tok)
        ran = {k: counters()[k].launches - before[k] for k in kernels}
        cpu = decode(q_cpu, cfg, mel, opts, tokenizer=tok)
        same = [a.tokens == b.tokens for a, b in zip(gpu, cpu)]
        log(f"[parity] test-tiny f32 int{bits} weights, {kv}, 2 rows x 16 "
            f"tokens: CUDA == CPU tokens per row {same}; CUDA launches {ran}")
        require(all(n > 0 for n in ran.values()), f"int{bits}: kernels ran")
        require(all(same), f"test-tiny int{bits} greedy tokens identical on "
                           f"CUDA and CPU")

    # whisper-small, f32, batch 2: informative only (random-init near-ties)
    cfg = CONFIGS["small"]
    cpu_params = init_params(cfg, seed=0)
    gpu_params = params_to(cpu_params, dev)
    mel = log_mel_spectrogram(torch.from_numpy(synthetic_audio(2, 30.0, seed=2)))
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=16, kv_int8=True)
    t0 = time.time()
    cpu = decode(cpu_params, cfg, mel, opts, tokenizer=tok)
    cpu_s = time.time() - t0
    gpu = decode(gpu_params, cfg, mel, opts, tokenizer=tok)
    agree = sum(x == y for a, b in zip(gpu, cpu) for x, y in zip(a.tokens, b.tokens))
    total = sum(max(len(a.tokens), len(b.tokens)) for a, b in zip(gpu, cpu))
    log(f"[parity] whisper-small f32 int8 cross-KV, 2 rows x 16 tokens: "
        f"{agree}/{total} token positions agree CUDA vs CPU (informative; "
        f"CPU decode {cpu_s:.1f} s)")


def phase_service(torch, dev, cfg, params, tok, **svc_kw):
    from whisper_ipa_torch.audio import N_SAMPLES, pad_or_trim
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.serve import TranscriptionService

    seconds = [5.0, 12.0, 40.0, 8.0, 20.0, 3.0]  # the third spans 2 windows
    clips = [synthetic_audio(1, s, seed=10 + i)[0] for i, s in enumerate(seconds)]
    svc = TranscriptionService(params, cfg, device=dev, batch_size=4,
                               max_wait_ms=1000.0, tokenizer=tok, **svc_kw)
    try:
        futs = [svc.submit(c) for c in clips]
        outs = [f.result(timeout=300) for f in futs]
        stats = svc.stats()
    finally:
        svc.close()
    require(not svc._thread.is_alive(), "service thread stopped")

    # the same windows in the same fixed batches of 4 (collected in order:
    # [r0, r1, r2a, r2b], then [r3, r4, r5, silence])
    windows = [pad_or_trim(c[s:s + N_SAMPLES])
               for c in clips for s in range(0, len(c), N_SAMPLES)]
    windows.append(np.zeros(N_SAMPLES, np.float32))
    ref = []
    for g in (windows[0:4], windows[4:8]):
        audio = torch.from_numpy(np.stack(g)).to(dev)
        with torch.inference_mode():
            mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
        ref.extend(decode(svc.params, cfg, mel, svc.options, tokenizer=tok))
    segs = [seg for o in outs for seg in o["segments"]]
    require(len(segs) == 7, f"7 windows answered, got {len(segs)}")
    for seg, r in zip(segs, ref):
        require(seg["text"] == r.text, "service text == decode() text")
        require(abs(seg["avg_logprob"] - r.avg_logprob) < 1e-3,
                "service avg_logprob == decode() avg_logprob")
    lat = [round(o["latency_sec"], 3) for o in outs]
    log(f"[service {svc_kw or 'default'}] 6 requests ({seconds} s audio) "
        f"resolved, texts and avg_logprobs equal decode() on the same windows; "
        f"latencies s {lat}; stats {stats}")


TRAIN_IPAS = ["kæt", "bʌtn̩", "ə̥tʃ", "aːm", "ɡɯɣ", "n̩æp", "t͡ʃiːz", "ŋ̊ʷa",
              "ðɪs ɪz", "wɔːtɚ", "ʃɪp", "θɹiː"]


def write_train_set(root: str, n: int, seed: int) -> str:
    """A seeded synthetic set in the pipeline's JSON schema: WAVs of a tone
    in noise, each with an IPA string from a fixed list."""
    from whisper_ipa_torch.audio import write_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        t = np.arange(int((2.0 + 0.5 * i) * SAMPLE_RATE)) / SAMPLE_RATE
        audio = (0.3 * np.sin(2 * np.pi * (150.0 + 40.0 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape))
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, audio.astype(np.float32))
        entries.append({"audio_path": path,
                        "ipa_transcription": TRAIN_IPAS[i % len(TRAIN_IPAS)],
                        "speaker_id": f"spk{i}"})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    return path


def read_train_log(out: str) -> dict:
    import csv

    with open(os.path.join(out, "training_log.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    return {int(r["step"]): (float(r["loss"]), float(r["step_time_sec"]))
            for r in rows}


def checkpoint_params(path: str):
    """The flat {canonical name: CPU tensor} of checkpoint dir ``path``."""
    from whisper_ipa_torch.models.convert import (
        flatten_params, load_safetensors_flat, params_from_flat)

    return flatten_params(params_from_flat(
        load_safetensors_flat(os.path.join(path, "model.safetensors"))))


def run_train(torch, dev, data: str, out: str, freeze: bool, steps: int,
              save_every: int, resume: bool = False):
    """train() at whisper-small, bf16 activations; returns (per-step
    (loss, step time s) from the log, launches, peak GB, wall s)."""
    from whisper_ipa_torch.train import train

    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    train(model_name="small", train_data_path=data, test_data_path=data,
          output_dir=out, num_steps=steps, batch_size=TRAIN_BATCH,
          learning_rate=TRAIN_LR, validate_every=0, save_every=save_every,
          resume=resume, mel_cache_dir=os.path.join(os.path.dirname(data),
                                                    "mels"),
          compute_dtype="bfloat16", freeze_encoder=freeze,
          final_validate=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    return read_train_log(out), launches, peak_gb, wall


def phase_train(torch, dev, tok, root: str):
    """Both fine-tuning modes through train(), the loop's validation, then
    save and resume. Each run's directory goes once it has been read (a
    whisper-small checkpoint with its optimizer state is ~3 GB)."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.models.convert import flatten_params, unflatten_params
    from whisper_ipa_torch.train import validate

    cfg = CONFIGS["small"]
    # as many utterances as the batch: every step sees the same batch
    data = write_train_set(os.path.join(root, "data"), TRAIN_BATCH, seed=0)
    init = flatten_params(init_params(cfg, seed=0))
    enc_names = [n for n in init if n.startswith("encoder.")]
    results = {}
    for mode, freeze in (("decoder-only", True), ("unfrozen", False)):
        out = os.path.join(root, mode)
        # the unfrozen run also saves at step 4, which the resume reads
        log_rows, launches, peak_gb, wall = run_train(
            torch, dev, data, out, freeze, TRAIN_STEPS,
            save_every=0 if freeze else 4)
        steps = sorted(log_rows)
        losses = [log_rows[s][0] for s in steps]
        steady = [log_rows[s][1] for s in steps[1:]]
        final = checkpoint_params(os.path.join(out, f"checkpoint-{TRAIN_STEPS}"))
        enc_same = all(torch.equal(final[n], init[n]) for n in enc_names)
        dec_moved = not torch.equal(final["decoder.token_embedding"],
                                    init["decoder.token_embedding"])
        log(f"[train {mode}] whisper-small bf16 activations, f32 AdamW, batch "
            f"{TRAIN_BATCH}, lr {TRAIN_LR:g}, {TRAIN_STEPS} steps on one fixed "
            f"batch: losses at steps {steps} {[round(x, 4) for x in losses]}; "
            f"step time (host clock, synchronised) first {log_rows[1][1]:.4f} s, "
            f"then {[round(x, 4) for x in steady]} s; peak device memory "
            f"{peak_gb:.2f} GB; wall {wall:.1f} s (checkpoint writes included); "
            f"launches {launches}; encoder unchanged {enc_same}")
        require(all(np.isfinite(losses)), f"{mode}: finite losses")
        require(losses[-1] < losses[0], f"{mode}: the loss fell")
        require(dec_moved, f"{mode}: the decoder moved")
        require(launches["K2"] == 12 * TRAIN_STEPS,
                f"{mode}: K2 launched 12 x steps, got {launches['K2']}")
        if freeze:
            require(launches["K5"] == 0, "decoder-only: no K5 launch")
            require(enc_same, "decoder-only: the encoder is bitwise unchanged")
            # the loop's validation on the card: language detected per row,
            # greedy decode of the trained decoder, PER/PFER
            dataset = create_data_loader(data, n_mels=cfg.n_mels)
            t0 = time.time()
            metrics = validate(params_to(unflatten_params(final), dev), cfg,
                               dataset, tok, num_samples=TRAIN_BATCH)
            log(f"[train validate] {TRAIN_BATCH} samples decoded with "
                f"language detection in {time.time() - t0:.1f} s: PER "
                f"{metrics['per']:.2f}%, PFER {metrics['pfer']:.2f}%")
            require(np.isfinite(metrics["per"]) and np.isfinite(metrics["pfer"]),
                    "validation metrics finite")
        else:
            require(launches["K5"] == 12 * TRAIN_STEPS,
                    f"unfrozen: K5 launched 12 x steps, got {launches['K5']}")
            require(not enc_same, "unfrozen: the encoder moved")
            os.rename(os.path.join(out, "checkpoint-4"),
                      os.path.join(root, "checkpoint-4"))
        shutil.rmtree(out)
        results[mode] = dict(launches=launches, log=log_rows,
                             steady_step_s=float(np.median(steady)),
                             peak_gb=peak_gb)

    # save and resume on the card: the unfrozen run's checkpoint-4, resumed
    # for one step in a fresh directory, against the uninterrupted step 5
    resumed = os.path.join(root, "resumed")
    os.makedirs(resumed)
    os.rename(os.path.join(root, "checkpoint-4"),
              os.path.join(resumed, "checkpoint-4"))
    log_rows, launches, _, _ = run_train(torch, dev, data, resumed, False, 5,
                                         save_every=0, resume=True)
    shutil.rmtree(resumed)
    want = results["unfrozen"]["log"][5][0]
    got = log_rows[5][0]
    rel = abs(got - want) / abs(want)
    log(f"[train resume] checkpoint-4 resumed on the card: step 5 loss {got:.6f}"
        f" vs uninterrupted {want:.6f} (relative {rel:.2e}, bound 1e-3); "
        f"launches {launches}")
    require(sorted(log_rows) == [5], "the resumed run starts at step 5")
    require(rel < 1e-3, "resumed loss within 1e-3 of the uninterrupted one")
    return results


def phase_train_parity(torch, dev):
    """test-tiny, f32: 5 train steps on CUDA against the same on the CPU."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.models.convert import flatten_params
    from whisper_ipa_torch.train.step import create_train_state, train_step

    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((2, 64, cfg.n_mels))
                           .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50000, (2, 16))).long()
    tokens[:, 12:] = 50257  # EOT
    losses = {}
    params = {}
    for side, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        state, tx = create_train_state(params_to(init_params(cfg, seed=0), d),
                                       learning_rate=1e-3,
                                       freeze_encoder=False)
        run = []
        for _ in range(5):
            state, loss = train_step(state, mel.to(d), tokens.to(d), cfg, tx,
                                     50257, freeze_encoder=False)
            run.append(float(loss))
        losses[side] = run
        params[side] = flatten_params(state.params)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    p_rel = max(max_abs(params["cuda"][n].cpu(), params["cpu"][n])
                / max(float(params["cpu"][n].abs().max()), 1e-12)
                for n in params["cpu"])
    log(f"[train parity] test-tiny f32, unfrozen, 5 steps: losses CUDA "
        f"{[round(x, 6) for x in losses['cuda']]} CPU "
        f"{[round(x, 6) for x in losses['cpu']]}; max relative loss "
        f"difference {rel:.2e} (bound 1e-4); final parameters max|diff|/max| "
        f"{p_rel:.2e}")
    require(rel < 1e-4, "CUDA training trajectory equals the CPU's")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import whisper_ipa_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the whisper_ipa_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.tokenizer import get_tokenizer
    from whisper_ipa_torch.models import init_params

    t_start = time.time()
    dev = torch.device("cuda", 0)
    card = phase_environment(torch)
    phase_build()

    kernels = []
    for name, check, source, replaces in (
        ("K1 log_mel_power", check_mel, "whisper_ipa_torch/csrc/mel.cu",
         "whisper_ipa_tpu/ops/mel_kernel.py:155"),
        ("K2 fused_attention", check_attention,
         "whisper_ipa_torch/csrc/attention.cu",
         "whisper_ipa_tpu/ops/attention.py:463"),
        ("K3 fused_kv_init_int8", check_kv_init,
         "whisper_ipa_torch/csrc/kv_init.cu",
         "whisper_ipa_tpu/ops/kv_init.py:135"),
        ("K4 decode_cross_attention_int8_tminor", check_decode_attention,
         "whisper_ipa_torch/csrc/decode_attention.cu",
         "whisper_ipa_tpu/ops/decode_attention.py:112"),
        ("K5 attention_backward", check_attention_backward,
         "whisper_ipa_torch/csrc/attention_bwd.cu",
         "whisper_ipa_tpu/ops/attention.py:216"),
        ("K6 int8_matmul", check_int8_matmul,
         "whisper_ipa_torch/csrc/quant_matmul.cu",
         "whisper_ipa_tpu/ops/quant_matmul.py:77"),
        ("K7 int4_matmul", check_int4_matmul,
         "whisper_ipa_torch/csrc/quant_matmul.cu",
         "whisper_ipa_tpu/ops/quant_matmul.py:190"),
        ("K8 decode_cross_attention_int4_tminor", check_decode_attention_int4,
         "whisper_ipa_torch/csrc/decode_attention.cu",
         "whisper_ipa_tpu/ops/decode_attention.py:236"),
    ):
        entry = check(torch, dev)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **entry))

    cfg = CONFIGS["small"]
    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    params = init_params(cfg, seed=0, device=dev)
    by_path = {}
    by_path["serving"], default_results = phase_serving_path(
        torch, dev, cfg, params, tok, "serving",
        {"K1": 1, "K2": cfg.n_audio_layer,
         "K4": (MAIN_SAMPLE_LEN - 1) * cfg.n_text_layer}, kv_int8=True)
    phase_quantized_paths(torch, dev, cfg, params, tok, by_path, default_results)
    phase_parity(torch, dev, tok)
    phase_service(torch, dev, cfg, params, tok)
    phase_service(torch, dev, cfg, params, tok, quant_bits=4, kv_int4=True)
    del params
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trained = phase_train(torch, dev, tok, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for mode, r in trained.items():
        by_path[f"train {mode}"] = r["launches"]
    phase_train_parity(torch, dev)
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")

    # launches: the sum over the paths of one counted run each (the four
    # serving runs, the two training modes), with the per-path counts
    # beside it
    for k in kernels:
        key = k["name"].split()[0]
        k["launches_by_path"] = {p: c[key] for p, c in by_path.items() if c[key]}
        k["launches"] = sum(k["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "launches_by_path")
    print(json.dumps({"kernels": [{k: e[k] for k in order} for e in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
