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
            greedy decode (K4), batch 16; the same batch with the encoder
            attention through the head-merged kernel (K10), tokens equal
            to the default's; CUDA against the CPU; the micro-batching
            service
  quantized serving, the same batch three more ways: the int8 cross cache
            built by the fused kernel (K3); int8 weights with int8
            activations (K6), the weights quantized on the host and again
            on the card (K9, stochastic rounding, one launch for the
            tree); int4 weights (K7) with the int4 cross cache (K8);
            test-tiny CUDA against the CPU for
            int8 and int4; the service with int4 weights and cache
  training  train() on a seeded synthetic set, batch 12, bf16
            activations: decoder-only (encoder frozen, K2 forward only)
            and --unfreeze-encoder (K2 forward, K5 backward); save and
            resume on the card; a test-tiny trajectory on CUDA against
            the CPU
  entry points, on the decoder-only run's checkpoint: the checkpoint
            loader, cli.evaluate_model, cli.transcribe_single, and the
            HTTP server of cli.serve (merged attention on: K10 in the
            service) with its texts against decode()

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


def bf16_within(got, want, atol: float) -> bool:
    """Every element within atol of the plain value, or within one bf16 ulp
    of it where that is larger: an output at or above 1 in magnitude whose
    fp32 sums round to the neighbouring bf16 value is 2^-7 off."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got.float() - w).abs() <= ulp.clamp_min(atol)).all())


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


def mel_function_flops(n_mels_nonzero: int) -> float:
    """fp32 operations a frame of the log-mel function needs (an FMA is
    two): the window (400 products), a 400-point real-input FFT at the
    usual count of 2.5 N log2 N (half a complex FFT's 5 N log2 N), |X|^2
    (3 a bin of 201) and one FMA per filterbank nonzero."""
    return 400 + 2.5 * 400 * np.log2(400) + 3 * 201 + 2 * n_mels_nonzero


def mel_factorized_flops(n_mels_nonzero: int) -> int:
    """fp32 operations a frame of K1's own algorithm does (an FMA is two):
    the window (400 products); stage 1, a 20-point DFT of each of 20
    columns at 11 outputs (2 FMAs a term); the twiddles (one product and
    one FMA a part, 220 outputs); stage 2, 201 bins of a 20-term complex
    sum (4 FMAs a term; 2 for bins 0, 20, .., 200 from a real input);
    |X|^2 (3 a bin); one FMA per filterbank nonzero."""
    from whisper_ipa_torch.ops.mel_kernel import FFT_HALF, FFT_RADIX

    r = FFT_RADIX
    stage1 = 2 * 2 * r * r * FFT_HALF
    twiddle = 6 * r * FFT_HALF
    stage2 = 2 * r * (4 * 190 + 2 * 11)
    return 400 + stage1 + twiddle + stage2 + 3 * 201 + 2 * n_mels_nonzero


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
        dev_ms, kernels = device_profile(
            torch, lambda: mk.log_mel_power(padded, n_mels), iters=20)
        require(kernels == 1,
                f"K1 n_mels={n_mels} one kernel a call (profiler: {kernels:g})")
        ops = mk._operators(n_mels, dev)
        frames = got.shape[0] * got.shape[1]
        nonzero = int((ops.mel_range[:, 1] - ops.mel_range[:, 0]).sum())
        # the bound: the bytes, or the operations the function needs, the
        # larger; beside it the counts of K1's factorized DFT and of the
        # direct DFT (the earlier design's: two (400 x 201) products, the
        # power spectrum and the dense mel product)
        io = nbytes(padded, got)
        b = bound(io, frames * mel_function_flops(nonzero), "fp32")
        fact = bound(io + nbytes(ops.window, ops.w20, ops.twiddle, ops.mel_t,
                                 ops.mel_range),
                     frames * mel_factorized_flops(nonzero), "fp32")
        dft = bound(io + nbytes(ops.cos_b, ops.sin_b, ops.mel_t),
                    frames * (2 * 2 * 400 * 201 + 3 * 201 + 2 * 201 * n_mels),
                    "fp32")
        log(f"[K1 mel] n_mels={n_mels} audio ({MAIN_BATCH}, 480000): "
            f"max|kernel-plain| "
            f"{err:.3e}, max|kernel-numpy| row 0 {err_np:.3e} (bound 5e-4); "
            f"kernel {ms:.4f} ms (device time {dev_ms:.4f} ms, {kernels:g} "
            f"kernel a call), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} "
            f"ms ({b['bound_by']}; a real FFT, window, power and {nonzero} "
            f"filterbank nonzeros): {b['bound_ms'] / dev_ms:.1%} of it "
            f"reached; factorized_bound_ms {fact['bound_ms']:.4f} (K1's own "
            f"operations): {fact['bound_ms'] / dev_ms:.1%}; "
            f"dft_product_bound_ms {dft['bound_ms']:.4f} (the direct DFT): "
            f"{dft['bound_ms'] / dev_ms:.1%}")
        require(err < 5e-4 and err_np < 5e-4, f"K1 n_mels={n_mels} within 5e-4")
        if n_mels == 80:
            # a yardstick for the DFT part alone: cuFFT's STFT (Hann,
            # center=False) of the same padded frames, no mel, no log
            window = torch.hann_window(400, periodic=True, device=dev)
            stft_ms = cuda_ms(lambda: torch.stft(
                padded, 400, 160, window=window, center=False,
                return_complex=True))
            log(f"[K1 mel] torch.stft (cuFFT) on the same padded frames: "
                f"{stft_ms:.4f} ms (the DFT alone; no single PyTorch call "
                f"computes the log-mel)")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                         library_ms=None, device_ms=dev_ms)
    return entry


def check_attention(torch, dev):
    from whisper_ipa_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    entry = None
    # bounds: f32 2e-5 (the TPU kernel's test bound); bf16 5e-3 absolute at
    # unit-normal inputs, or one bf16 ulp of outputs at or above 1: both
    # sides sum in f32 and round P to bf16 before the value product, at
    # values that differ in the last bits
    for dh, dtype, tol in (
        (64, torch.bfloat16, 5e-3),
        (64, torch.float32, 2e-5),
        (32, torch.bfloat16, 5e-3),
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
        ok = bf16_within(got, want, tol) if dtype == torch.bfloat16 else err < tol
        require(ok, f"K2 dh={dh} {dtype} within {tol}")
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


def device_profile(torch, fn, iters: int = 50, attempts: int = 5):
    """(device ms, kernels) of one fn() call: its kernels' time and count
    under torch.profiler over iters calls, after a warm-up. Unlike cuda_ms
    it leaves out the host's time between launches, which dominates at
    microsecond scale. Every fn() here launches the same kernels on every
    call, so a window whose record count is not a whole number a call lost
    (or gained) records: the profiler sometimes drops the records of a
    microsecond kernel, or of a whole window. Such a window is logged with
    its records by name and profiled again; after ``attempts`` windows the
    last one's numbers are returned as they are (a caller's kernel-count
    check then fails), and a fn() that shows no kernel in any window
    raises."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    last = None
    for attempt in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            log(f"[profiler] window {attempt + 1}/{attempts} of {iters} calls "
                f"recorded no device kernel; profiled again")
            continue
        count = sum(e.count for e in events)
        last = (sum(e.self_device_time_total for e in events) / iters / 1e3,
                count / iters)
        if count % iters == 0:
            return last
        log(f"[profiler] window {attempt + 1}/{attempts} of {iters} calls "
            f"recorded {count} kernels, not a whole number a call ("
            + "; ".join(f"{e.key}: {e.count}" for e in events)
            + "); profiled again")
    if last is None:
        raise RuntimeError(f"torch.profiler recorded no device kernel in "
                           f"{attempts} windows of {iters} calls")
    return last


def device_ms(torch, fn, iters: int = 50) -> float:
    """Device time of one fn() call in ms (``device_profile``)."""
    return device_profile(torch, fn, iters)[0]


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
        dev_ms, kernels = device_profile(
            torch, lambda: da.decode_cross_attention_int8_tminor(q, k, ks, v, vs))
        # q.k over every cached position and p.v back, 2 flops a MAC
        b = bound(nbytes(q, k, ks, v, vs, got), 4 * B * H * Dh * T_pad, "bf16")
        log(f"[K4 decode attention] B={B} H=12 Dh=64 T_pad=1536 (scale 0 from "
            f"1500) q {str(dtype)[6:]}: max|kernel-plain| {err:.3e} "
            f"({tol}); vs f32 on the same inputs: kernel "
            f"{max_abs(got, exact):.3e}, plain {max_abs(want, exact):.3e}; "
            f"kernel {ms:.4f} ms (device time {dev_ms:.4f} ms, {kernels:g} "
            f"kernel a call, profiler), plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
            f"{b['bound_ms'] / dev_ms:.1%} of it reached")
        require(ok, f"K4 q {dtype} within bound")
        require(kernels == 1,
                f"K4 q {dtype} one kernel a call (profiler: {kernels:g})")
        if entry is None:
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                         library_ms=None, device_ms=dev_ms, kernels_a_call=kernels)
        else:
            entry["device_ms_f32"] = dev_ms

    # a serving step reads twelve layers' caches in turn, so none is in the
    # 50 MB L2 cache when its layer comes: three caches (120 MB) in turn
    caches = [(k, ks, v, vs)] + [(codes(), scales(), codes(), scales())
                                 for _ in range(2)]
    q = q32.to(torch.bfloat16)
    turn = iter(range(10 ** 9))

    def rotating():
        return da.decode_cross_attention_int8_tminor(q, *caches[next(turn) % 3])

    cold_ms, _ = device_profile(torch, rotating, iters=51)
    log(f"[K4 decode attention] bf16 q over three caches in turn (L2 cold): "
        f"device time {cold_ms:.4f} ms, {entry['bound_ms'] / cold_ms:.1%} of "
        f"the bound reached")
    entry["device_ms_cold"] = cold_ms

    # the split of T that k4_split_plan picks (6 x 256) against its
    # neighbours, through the entry point (device ms, profiler)
    row = []
    for splits in (4, 6, 8):
        call = lambda splits=splits: da.launch_cluster(  # noqa: E731
            "int8", q, k, ks, v, vs, splits, T_pad // splits)
        row.append(f"{splits} x {T_pad // splits}: "
                   f"{device_profile(torch, call)[0]:.4f}")
    log(f"[K4 decode attention] splits of T_pad 1536 (plan: "
        f"{da.k4_split_plan(T_pad)}), bf16 q, device ms: " + "; ".join(row))
    return entry


def check_attention_backward(torch, dev):
    from whisper_ipa_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, T = TRAIN_BATCH, 12, 1500
    entry = None
    # bounds, relative to max|grad|: f32 1e-4 (the CPU tests hold the plain
    # version to the TPU kernel at 1e-5; here the kernel sums 1500 terms in
    # another order than cuBLAS); bf16 1e-2: both sides round P and dS to
    # bf16 before their products (one ulp 2^-8 relative) at values that
    # differ in the last bits
    for dh, dtype, tol in (
        (64, torch.bfloat16, 1e-2),
        (64, torch.float32, 1e-4),
        (32, torch.bfloat16, 1e-2),
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
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def fwd_bwd(fn):
                o = fn(qg, kg, vg, scale=scale)
                return torch.autograd.grad(o, (qg, kg, vg), g)

            # like for like: SDPA's backward alone, on a saved forward
            o_lib = sdpa(qg, kg, vg, scale=scale)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                o_lib, (qg, kg, vg), g, retain_graph=True))
            del o_lib
            lib_fb_ms = cuda_ms(lambda: fwd_bwd(sdpa))
            ours_ms = cuda_ms(lambda: fwd_bwd(at.fused_attention))
            log(f"[K5 attention backward] library: scaled_dot_product_attention "
                f"backward alone {lib_ms:.4f} ms on the same inputs; forward + "
                f"backward: library {lib_fb_ms:.4f} ms, the port's K2 + K5 "
                f"{ours_ms:.4f} ms")
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
        equal, worst, scale_rel, over = [], 0, 0.0, 0
        for i in (0, 2):
            require(got[i].shape == (B, H, 64, 1536), f"K3 shape {tuple(got[i].shape)}")
            diff = (got[i].int() - want[i].int()).abs()
            same = (got[i + 1] == want[i + 1])[:, :, None, :]
            over += int((diff > torch.where(same, 1, 2)).sum())
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
            f"{bias is not None}: codes equal {min(equal):.6f}, max|diff| "
            f"{worst} (scale-aware bound 1/2; {over} codes past it), scales max relative "
            f"{scale_rel:.3e} (bound {tol:g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        require(over == 0 and min(equal) >= 0.999 and scale_rel <= tol,
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
    weights = {}

    def codes(k, n):
        if (k, n) not in weights:
            q = quantize_linear({"w": 0.05 * torch.randn((k, n), generator=gen,
                                                         device=dev)})
            weights[k, n] = q["w_q"].to(dev), q["w_s"].to(dev)
        return weights[k, n]

    entry = None
    # the encoder's and cross projections' rows (B * 1500), then the decode
    # step's 16 rows, where 6144 of the int8 run's 6240 launches run; both
    # bodies must equal the plain version bit for bit (exact integer sums,
    # the same IEEE scales and f32 rescale)
    for m, k, n, dtype in ((24000, 768, 768, torch.bfloat16),
                           (16, 768, 768, torch.bfloat16),
                           (24000, 3072, 768, torch.bfloat16),
                           (16, 3072, 768, torch.bfloat16),
                           (16, 768, 3072, torch.float32),
                           (48, 768, 768, torch.bfloat16)):
        w_q, w_s = codes(k, n)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        before = qm.int8_matmul.launches
        got = qm.int8_matmul(x, w_q, w_s)
        torch.cuda.synchronize()
        require(qm.int8_matmul.launches == before + 1, "K6 counter rose")
        want = qm.int8_matmul_plain(x, w_q, w_s)
        exact = torch.equal(got, want)
        ms = cuda_ms(lambda: qm.int8_matmul(x, w_q, w_s))
        plain_ms = cuda_ms(lambda: qm.int8_matmul_plain(x, w_q, w_s))
        dev_ms = device_ms(torch, lambda: qm.int8_matmul(x, w_q, w_s))
        lib = ""
        lib_ms = None
        if m > 16:  # cuBLASLt's int8 product wants more than 16 rows
            xf = x.float()
            s = xf.abs().amax(1, keepdim=True).clamp_min(1e-6) / 127
            x_codes = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
            lib_ms = cuda_ms(lambda: torch._int_mm(x_codes, w_q))
            lib = f", library torch._int_mm on the same codes (product alone) {lib_ms:.4f} ms"
        b = bound(nbytes(x, w_q, w_s, got), 2 * m * k * n, "int8")
        log(f"[K6 int8 matmul] ({m}, {k}) {str(dtype)[6:]} x ({k}, {n}) int8, "
            f"{'split-K' if m <= qm.SMALL_M_MAX else 'tiled'} body: equal to "
            f"the plain version bit for bit {exact}; kernel {ms:.4f} ms "
            f"(device time {dev_ms:.4f} ms, profiler), plain {plain_ms:.4f} "
            f"ms, bound {b['bound_ms']:.4f} ms{lib}")
        require(exact, f"K6 ({m}, {k}, {n}) {dtype} equal to its plain version")
        if entry is None:
            entry = dict(max_abs_err=max_abs(got, want), ms=ms, plain_ms=plain_ms,
                         **b, library_ms=lib_ms)
        elif (m, k, n) == (16, 768, 768):
            entry.update(decode_shape=[m, k, n], decode_ms=ms,
                         decode_device_ms=dev_ms, decode_plain_ms=plain_ms,
                         decode_bound_ms=b["bound_ms"])

    # the threshold between the bodies: both at the decode and prefix rows
    # (device time, profiler)
    for k, n in ((768, 768), (3072, 768)):
        w_q, w_s = codes(k, n)
        row = []
        for m in (16, 32, 48, 64):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            times = [device_ms(torch, lambda: qm._int8_kernel(x, w_q, w_s, small))
                     for small in (True, False)]
            row.append(f"M {m}: split-K {times[0]:.4f}, tiled {times[1]:.4f}")
        log(f"[K6 int8 matmul] bodies at ({k}, {n}), device ms: " + "; ".join(row))
    return entry


def int4pack_library(torch, x, w_q4, w_s4):
    """PyTorch's int4-weight product (``torch._weight_int4pack_mm``, the
    tinygemm kernel) on K7's codes and scales: the codes offset by 8 and
    repacked by ``torch._convert_weight_to_int4pack``, group 64, zeros 0,
    the scales in bf16 as that call requires. Returns (ms, device ms,
    error relative to max|plain|) on bf16 x, or None where this torch
    lacks the call."""
    from whisper_ipa_torch.ops import quant_matmul as qm
    from whisper_ipa_torch.ops.quant import unpack_nibbles

    if not (hasattr(torch, "_weight_int4pack_mm")
            and hasattr(torch, "_convert_weight_to_int4pack")):
        return None
    n_half, n = w_q4.shape
    group = 2 * n_half // w_s4.shape[0]
    lo, hi = unpack_nibbles(w_q4, torch.int32)
    codes = torch.stack([lo, hi], dim=1).reshape(2 * n_half, n).t() + 8
    packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).to(torch.uint8).contiguous()
    w = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([w_s4, torch.zeros_like(w_s4)], dim=-1).to(torch.bfloat16)
    sz = sz.contiguous()
    xb = x.to(torch.bfloat16)
    y = torch._weight_int4pack_mm(xb, w, group, sz)
    err = rel_err(y, qm.int4_matmul_plain(xb, w_q4, w_s4))
    call = lambda: torch._weight_int4pack_mm(xb, w, group, sz)  # noqa: E731
    return cuda_ms(call), device_profile(torch, call)[0], err


def check_int4_matmul(torch, dev):
    from whisper_ipa_torch.ops import quant_matmul as qm
    from whisper_ipa_torch.ops.quant import quantize_linear_int4

    gen = torch.Generator(device=dev).manual_seed(0)
    weights = {}
    entry = None
    decode_shapes = []
    # the int4 run's decode step (16 rows: fc1, fc2 and the 768 x 768
    # projections) and prefix step (48 rows), 64 rows (the split-K body's
    # largest) and 65 (the warps-split body); bound 1e-5 of max|y|
    for m, k, n in ((16, 768, 3072), (64, 768, 3072), (16, 3072, 768),
                    (64, 3072, 768), (48, 768, 768), (16, 768, 768),
                    (65, 3072, 768)):
        if (k, n) not in weights:
            q = quantize_linear_int4(
                {"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
            weights[k, n] = q["w_q4"].to(dev), q["w_s4"].to(dev)
        w_q4, w_s4 = weights[k, n]
        decode = m in (16, 48)
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
            b = bound(nbytes(x, w_q4, w_s4, got), 2 * m * k * n, "fp32")
            body = ("split-K" if qm.int4_uses_split_k(
                m, k, n, w_q4.shape[0] // w_s4.shape[0], x.element_size())
                else "warps-split")
            timing = ""
            if decode:
                dev_ms, kernels = device_profile(
                    torch, lambda: qm.int4_matmul(x, w_q4, w_s4))
                require(kernels == 1,
                        f"K7 ({m}, {k}, {n}) one kernel a call (profiler: {kernels:g})")
                timing = (f" (device time {dev_ms:.4f} ms, {kernels:g} kernel a "
                          f"call, profiler), bound {b['bound_ms']:.4f} ms "
                          f"({b['bound_by']}): {b['bound_ms'] / dev_ms:.1%} of "
                          f"it reached")
                lib = (int4pack_library(torch, x, w_q4, w_s4)
                       if dtype == torch.bfloat16 else None)
                if lib is not None:
                    timing += (f"; torch._weight_int4pack_mm {lib[0]:.4f} ms "
                               f"(device time {lib[1]:.4f} ms), error "
                               f"{lib[2]:.3e} of max|plain| (bf16 scales)")
                decode_shapes.append(dict(
                    shape=[m, k, n], dtype=str(dtype)[6:], ms=ms,
                    device_ms=dev_ms, plain_ms=plain_ms, **b,
                    library_ms=None if lib is None else lib[0],
                    library_device_ms=None if lib is None else lib[1],
                    library_err=None if lib is None else lib[2]))
            log(f"[K7 int4 matmul] ({m}, {k}) {str(dtype)[6:]} x packed "
                f"({k // 2}, {n}), {body} body: max|kernel-plain|/max|plain| "
                f"{err:.3e} (bound 1e-5); kernel {ms:.4f} ms{timing}, plain "
                f"{plain_ms:.4f} ms")
            require(err <= 1e-5, f"K7 ({m}, {k}, {n}) {dtype} within 1e-5")
            if entry is None:
                entry = dict(max_abs_err=max_abs(got, want), ms=ms,
                             plain_ms=plain_ms, **b,
                             library_ms=decode_shapes[-1]["library_ms"],
                             library_device_ms=decode_shapes[-1]["library_device_ms"],
                             library_err=decode_shapes[-1]["library_err"],
                             device_ms=dev_ms)
    entry["decode_shapes"] = decode_shapes
    return entry


def check_decode_attention_int4(torch, dev):
    from whisper_ipa_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, T, T_pad = MAIN_BATCH, 12, 1500, 1536
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
            exact = da.decode_attention_int4_plain(q.float(), k, ks, v, vs)
            call = lambda: da.decode_cross_attention_int4_tminor(q, k, ks, v, vs)  # noqa: E731
            ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: da.decode_attention_int4_plain(q, k, ks, v, vs))
            dev_ms, kernels = device_profile(torch, call)
            # q.k over every cached position and p.v back, 2 flops a MAC,
            # f32 on the CUDA cores
            b = bound(nbytes(q, k, ks, v, vs, got), 4 * B * H * dh * T_pad, "fp32")
            log(f"[K8 int4 decode attention] B={B} H={H} Dh={dh} T_pad={T_pad} "
                f"(scale 0 from {T}) q {str(dtype)[6:]}, plan "
                f"{da.k8_split_plan(T_pad, B * H, sms)}: "
                f"max|kernel-plain|/max|plain| "
                f"{err:.3e} (bound {tol:g}); vs f32 on the same inputs: "
                f"kernel {rel_err(got, exact):.3e}, plain {rel_err(want, exact):.3e}; "
                f"kernel {ms:.4f} ms (device time {dev_ms:.4f} ms, {kernels:g} "
                f"kernel a call, profiler), plain {plain_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
                f"{b['bound_ms'] / dev_ms:.1%} of it reached")
            require(err <= tol, f"K8 Dh {dh} q {dtype} within {tol}")
            require(kernels == 1,
                    f"K8 Dh {dh} q {dtype} one kernel a call (profiler: {kernels:g})")
            if entry is None:
                entry = dict(max_abs_err=max_abs(got, want), ms=ms,
                             plain_ms=plain_ms, **b, library_ms=None,
                             device_ms=dev_ms, kernels_a_call=kernels)
            elif dh == 64:
                entry["device_ms_f32"] = dev_ms
        if dh == 64:
            # the splits of T_pad 1536 against the plan's, through the entry
            # point (device ms, profiler), bf16 q, at the main path's B*H,
            # the int4 service's (batch 4) and one request's
            q = q32.to(torch.bfloat16)
            sweep = {}
            for b in (B, 4, 1):
                row = []
                for splits in (2, 3, 4, 6, 8):
                    slice_t = -(-T_pad // (32 * splits)) * 32
                    call = lambda b=b, splits=splits, slice_t=slice_t: (  # noqa: E731
                        da.launch_cluster("int4", q[:b], k[:b], ks[:b], v[:b],
                                          vs[:b], splits, slice_t))
                    row.append(f"{splits} x {slice_t}: "
                               f"{device_profile(torch, call)[0]:.4f}")
                log(f"[K8 int4 decode attention] B*H {b * H}: splits of T_pad "
                    f"1536 (plan: {da.k8_split_plan(T_pad, b * H, sms)}), bf16 "
                    f"q, device ms: " + "; ".join(row))
                sweep[f"bh{b * H}"] = row
            entry["split_device_ms"] = sweep
    return entry


def sr_quant_flops(rows: int, cols: int) -> float:
    """Integer and fp32 operations K9's function needs for a weight (an
    op each, at the CUDA cores' fp32 rate: the table has no int32 rate):
    a Philox4x32-10 block a 4 elements (10 rounds of two 32 x 32 -> 64-bit
    products, hi and lo, and 4 xors, and 9 key bumps of 2 adds: 98), u from
    the bits (shift, or, subtract: 3), the division, add, floor, 2 clamps
    and the conversion (6), and |w| and the column max (2): 35.5 an
    element."""
    return (98 / 4 + 3 + 6 + 2) * rows * cols


def check_sr_quant(torch, dev):
    from whisper_ipa_torch.ops import sr_quant as sr

    gen = torch.Generator(device=dev).manual_seed(0)
    entry = None
    # the shapes of whisper-small's block weights, one weight a launch; the
    # kernel and the plain version compute the same Philox bits and IEEE
    # divisions: equal codes and scales; each code the floor or the ceiling
    # of the IEEE quotient
    for rows, cols in ((768, 3072), (3072, 768), (768, 768)):
        w = 0.05 * torch.randn((rows, cols), generator=gen, device=dev)
        before = sr.stochastic_quantize_int8_many.launches
        q, s = sr.stochastic_quantize_int8(w, seed=7)
        torch.cuda.synchronize()
        require(sr.stochastic_quantize_int8_many.launches == before + 1,
                "K9 counter rose")
        pq, ps = sr.stochastic_quantize_int8_plain(w, seed=7)
        exact = torch.equal(q, pq) and torch.equal(s, ps)
        quot = w / s[None, :]  # a tensor divisor: the IEEE quotient on CUDA
        lo = torch.floor(quot).clamp(-127, 127)
        hi = (torch.floor(quot) + 1).clamp(-127, 127)
        qf = q.float()
        bracket = bool(((qf == lo) | (qf == hi)).all())
        step_err = float(((qf * s - w).abs() / s).max())
        call = lambda: sr.stochastic_quantize_int8(w, seed=7)  # noqa: E731
        ms = cuda_ms(call)
        dev_ms, kernels = device_profile(torch, call)
        plain_ms = cuda_ms(lambda: sr.stochastic_quantize_int8_plain(w, seed=7))
        # bytes: w read, codes and scales written
        b = bound(nbytes(w, q, s), sr_quant_flops(rows, cols), "fp32")
        log(f"[K9 sr quant] w ({rows}, {cols}) f32: codes and scales equal the "
            f"plain version's {exact}; every code floor or ceil of the IEEE "
            f"quotient {bracket}; max error {step_err:.4f} steps (bound 1); "
            f"kernel {ms:.4f} ms (device time {dev_ms:.4f} ms, {kernels:g} "
            f"kernel a call, profiler), plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}): "
            f"{b['bound_ms'] / dev_ms:.1%} of it reached")
        require(exact and bracket and step_err <= 1.0,
                f"K9 ({rows}, {cols}) exact, bracketed, within one step")
        require(kernels == 1, f"K9 ({rows}, {cols}) one kernel a call "
                f"(profiler: {kernels:g})")
        if entry is None:
            entry = dict(max_abs_err=max_abs(q, pq), ms=ms, plain_ms=plain_ms,
                         **b, library_ms=None, device_ms=dev_ms,
                         kernels_a_call=kernels)
    w2 = torch.full((4096, 8), 0.25, device=dev)
    w2[0] = 127.0  # scale 1.0: codes 0 or 1 with P(1) = 0.25
    q2, s2 = sr.stochastic_quantize_int8(w2, seed=11)
    mean = float((q2[1:].float() * s2).mean())
    log(f"[K9 sr quant] quarter-step unbiasedness: mean {mean:.4f} "
        f"(0.25 within 0.02)")
    require(bool((s2 == 1.0).all()) and abs(mean - 0.25) < 0.02,
            "K9 unbiased on quarter steps")
    return entry


def check_merged_attention(torch, dev):
    from whisper_ipa_torch.models.layers import merge_heads, split_heads
    from whisper_ipa_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, H, dh = MAIN_BATCH, 1500, 12, 64
    scale = dh ** -0.5
    entry = None
    # bounds against the plain version: K2's (bf16 5e-3 absolute or one
    # ulp, f32 2e-5); against K2 on split heads: equal (one body, one order)
    for dtype, tol in ((torch.bfloat16, 5e-3), (torch.float32, 2e-5)):
        q, k, v = (torch.randn((B, T, H * dh), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        before = at.fused_attention_merged.launches
        got = at.fused_attention_merged(q, k, v, H, scale)
        torch.cuda.synchronize()
        require(at.fused_attention_merged.launches == before + 1,
                "K10 counter rose")
        want = at.attention_merged_plain(q, k, v, H, scale)
        err = max_abs(got, want)
        split = [split_heads(t, H).contiguous() for t in (q, k, v)]
        k2 = merge_heads(at.fused_attention(*split, scale))
        same = torch.equal(got, k2)
        ms = cuda_ms(lambda: at.fused_attention_merged(q, k, v, H, scale))
        plain_ms = cuda_ms(lambda: at.attention_merged_plain(q, k, v, H, scale))
        log(f"[K10 merged attention] ({B}, {T}, {H}x{dh}) {str(dtype)[6:]}: "
            f"max|kernel-plain| {err:.3e} (bound {tol:g}); equal to K2 on "
            f"split heads {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        ok = bf16_within(got, want, tol) if dtype == torch.bfloat16 else err < tol
        require(ok and same, f"K10 {dtype} within {tol} and equal to K2")
        if entry is None:
            views = [t.view(B, T, H, dh).transpose(1, 2) for t in (q, k, v)]
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(*views, scale=scale))
            log(f"[K10 merged attention] library: scaled_dot_product_attention "
                f"on the (B, T, H, Dh).transpose(1, 2) views {lib_ms:.4f} ms")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound(nbytes(q, k, v, got), 4 * B * H * T * T * dh,
                                 "bf16"),
                         library_ms=lib_ms)

    # the autograd Function: K10 forward with the LSE, K5 backward on split
    # heads, against the plain backward (K5's bf16 bound, relative)
    Bg = 2
    q, k, v, g = (torch.randn((Bg, T, H * dh), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k10, k5 = at.fused_attention_merged.launches, at.attention_backward.launches
    got = torch.autograd.grad(at.fused_attention_merged(*leaves, H, scale),
                              leaves, g)
    torch.cuda.synchronize()
    require(at.fused_attention_merged.launches == k10 + 1
            and at.attention_backward.launches == k5 + 1,
            "the Function ran K10 forward and K5 backward")
    want = at.attention_backward_plain(*(split_heads(t, H) for t in (q, k, v, g)),
                                       scale)
    rel = [rel_err(a, merge_heads(b)) for a, b in zip(got, want)]
    log(f"[K10 merged attention] forward + backward ({Bg}, {T}, {H}x{dh}) bf16 "
        f"through the Function (K10 + K5): max|grad-plain|/max|plain| dq/dk/dv "
        f"{'/'.join(f'{x:.2e}' for x in rel)} (bound 1e-2)")
    require(max(rel) < 1e-2, "K10 + K5 gradients within 1e-2")
    return entry


def counters():
    from whisper_ipa_torch.ops import (attention, decode_attention, kv_init,
                                       mel_kernel, quant_matmul, sr_quant)

    return {
        "K1": mel_kernel.log_mel_power,
        "K2": attention.fused_attention,
        "K3": kv_init.fused_kv_init_int8,
        "K4": decode_attention.decode_cross_attention_int8_tminor,
        "K5": attention.attention_backward,
        "K6": quant_matmul.int8_matmul,
        "K7": quant_matmul.int4_matmul,
        "K8": decode_attention.decode_cross_attention_int4_tminor,
        "K9": sr_quant.stochastic_quantize_int8_many,
        "K10": attention.fused_attention_merged,
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


def phase_merged_path(torch, dev, cfg, params, tok, by_path, default_results):
    """The main path's batch with the encoder attention through K10."""
    from whisper_ipa_torch.models import use_merged_attention

    steps = MAIN_SAMPLE_LEN - 1
    try:
        use_merged_attention(True)
        by_path["serving merged"], merged = phase_serving_path(
            torch, dev, cfg, params, tok, "serving merged",
            {"K1": 1, "K2": 0, "K10": cfg.n_audio_layer,
             "K4": steps * cfg.n_text_layer}, kv_int8=True)
    finally:
        use_merged_attention(False)
    same = sum(x == y for a, b in zip(merged, default_results)
               for x, y in zip(a.tokens, b.tokens))
    log(f"[serving merged] {same}/{MAIN_BATCH * MAIN_SAMPLE_LEN} token "
        f"positions equal the default serving run's (K10 equals K2 on split "
        f"heads bit for bit)")
    require(same == MAIN_BATCH * MAIN_SAMPLE_LEN,
            "merged serving tokens equal the default's")


WITNESS = 10  # launches of K9's witness window (phase_device_quantize)


def phase_device_quantize(torch, dev, cfg, params, q8_host, by_path):
    """quantize_params_device (K9) on the card-resident params: one launch
    for the tree, each weight equal to its plain version, held against the
    host quantizer's tree and timed; returns the quantized tree and the
    tree's numbers for K9's entry."""
    from whisper_ipa_torch.models import flatten_params
    from whisper_ipa_torch.ops import sr_quant as sr

    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    d8 = sr.quantize_params_device(params)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    by_path["device quantize int8"] = launches
    require({k: c for k, c in launches.items() if c} == {"K9": 1},
            f"K9 launched once for the tree, got {launches}")
    n_weights = 6 * (cfg.n_audio_layer + cfg.n_text_layer) + 4 * cfg.n_text_layer
    src, dev_flat = flatten_params(params), flatten_params(d8)
    host_flat = flatten_params(q8_host)
    require(sorted(dev_flat) == sorted(host_flat), "the host quantizer's layout")
    scales = [n for n in dev_flat if n.endswith(".w_s")]
    require(len(scales) == n_weights, f"{n_weights} quantized weights")
    require(all(dev_flat[n].device == dev for n in dev_flat), "stays on the card")
    scales_equal = all(torch.equal(dev_flat[n], host_flat[n]) for n in scales)
    code_diff = max(int((dev_flat[n[:-1] + "q"].int()
                         - host_flat[n[:-1] + "q"].int()).abs().max())
                    for n in scales)
    # each weight against its plain version, seeds in the reference's visit
    # order (decoder blocks, then encoder blocks)
    order = [n[:-2] for side in ("decoder", "encoder") for n, t in src.items()
             if n.startswith(side + ".blocks.") and n.endswith(".w")
             and t.dim() == 2]
    exact = all(
        all(torch.equal(a, b) for a, b in zip(
            (dev_flat[n + ".w_q"], dev_flat[n + ".w_s"]),
            sr.stochastic_quantize_int8_plain(src[n + ".w"], 1 + i)))
        for i, n in enumerate(order))
    call = lambda: sr.quantize_params_device(params)  # noqa: E731
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        call()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    # the call launches nothing but K9 (its table is the kernel's
    # parameter; no copy, no fill), so the profile's time a recorded
    # kernel is the tree's device time. On an H100 the profiler recorded 8
    # of 10 launches in some windows of this phase, so the count is held to
    # at most one a call, and a witness shows that every launch runs: the
    # tree's launch WITNESS times in turn, each into codes and scales of
    # its own filled with sentinels (-128, which the kernel never writes,
    # and NaN), profiled as one window; every set must then hold the
    # tree's codes and scales
    window_ms, kernels = device_profile(torch, call, iters=10)
    dev_ms = window_ms / kernels if kernels else float("nan")
    ws = [src[n + ".w"].to(torch.float32).contiguous() for n in order]
    seeds = [1 + i for i in range(len(ws))]
    sets = [sr._outputs([tuple(w.shape) for w in ws], dev)
            for _ in range(WITNESS)]
    for qs, ss in sets:
        for q, s in zip(qs, ss):
            q.fill_(-128)
            s.fill_(float("nan"))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for qs, ss in sets:
            sr._launch(ws, qs, ss, seeds, dev)
        torch.cuda.synchronize()
    k9 = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "sr_quant_kernel" in e.key]
    witness_recorded = sum(e.count for e in k9)
    witness_ms = (sum(e.self_device_time_total for e in k9) / 1e3
                  / max(witness_recorded, 1))
    written = sum(all(torch.equal(q, dev_flat[n + ".w_q"])
                      and torch.equal(s, dev_flat[n + ".w_s"])
                      for n, q, s in zip(order, qs, ss)) for qs, ss in sets)
    del sets
    w_bytes = sum(src[n + ".w"].numel() * 4 for n in order)
    elems = w_bytes // 4
    b = bound(w_bytes + elems + sum(dev_flat[n + ".w_s"].numel() * 4
                                    for n in order),
              sum(sr_quant_flops(*src[n + ".w"].shape) for n in order), "fp32")
    log(f"[device quantize] whisper-small int8 on the card (K9, {n_weights} "
        f"weights, {elems} elements, one launch) in {wall:.4f} s (host "
        f"clock, synchronised; then {[round(x, 4) for x in walls]}); device "
        f"time {dev_ms:.4f} ms a launch ({kernels:g} kernels recorded a call, "
        f"profiler; witness: {written} of {WITNESS} launches wrote every "
        f"code and scale over sentinels, {witness_recorded} kernels "
        f"recorded, {witness_ms:.4f} ms a recorded kernel), bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}): {b['bound_ms'] / dev_ms:.1%} "
        f"of it reached; every weight equal to its plain version {exact}; "
        f"scales equal the host quantizer's {scales_equal}; codes within "
        f"{code_diff} of its round-to-nearest codes (bound 1)")
    require(exact, "K9 tree equal to the plain version weight by weight")
    require(written == WITNESS, f"K9 witness: every launch wrote the tree "
            f"({written} of {WITNESS})")
    require(0 < kernels <= 1,
            f"K9 tree at most one kernel a call (profiler: {kernels:g})")
    require(scales_equal and code_diff <= 1, "K9 tree against the host's")
    return d8, dict(tree_device_ms=dev_ms, tree_wall_s=wall, tree_walls_s=walls)


def phase_quantized_paths(torch, dev, cfg, params, tok, by_path, default_results):
    """The three quantized serving runs of the main path's batch, and the
    int8 run again with the weights quantized on the card (K9); returns
    the card quantizer's numbers for K9's entry."""
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
    log(f"[quantize] whisper-small int8 on the host in {time.time() - t0:.4f} s")
    d8, k9_tree = phase_device_quantize(torch, dev, cfg, params, q8, by_path)
    # every int8 linear: 6 an encoder layer, the 2 cross projections a
    # decoder layer in init_cache, 8 a decoder layer a step
    int8_expect = {"K1": 1, "K2": n_enc, "K6": 6 * n_enc + 2 * n_dec
                   + 8 * n_dec * MAIN_SAMPLE_LEN, "K4": steps * n_dec}
    try:
        use_int8_activations(True)
        by_path["serving int8"], _ = phase_serving_path(
            torch, dev, cfg, q8, tok, "serving int8", int8_expect, kv_int8=True)
        by_path["serving device-int8"], _ = phase_serving_path(
            torch, dev, cfg, d8, tok, "serving device-int8", int8_expect,
            kv_int8=True)
    finally:
        use_int8_activations(False)
    del q8, d8

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
    return k9_tree


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


def _http(url: str, body: bytes = None, content_type: str = "audio/wav"):
    """GET (no body) or POST ``url``; the response's lines, JSON-decoded."""
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as r:
        return [json.loads(line) for line in r if line.strip()]


def phase_entry_points(torch, dev, cfg, data: str, run_dir: str, ckpt_flat,
                       by_path):
    """The inference entry points on the decoder-only run's checkpoint, at
    whisper-small: the loader, the evaluation CLI, the single-file CLI and
    the HTTP server (merged attention on, so K10 runs in the service)."""
    import threading

    from whisper_ipa_torch.audio import (N_SAMPLES, load_audio_bytes,
                                         pad_or_trim, write_wav)
    from whisper_ipa_torch.cli import evaluate_model, transcribe_single
    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.models import (checkpoint_overlay_mode,
                                          flatten_params, load_checkpoint_auto,
                                          use_merged_attention)
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.train.loop import load_or_init_params

    t_phase = time.time()
    ckpt = os.path.join(run_dir, f"checkpoint-{TRAIN_STEPS}")
    # no weights on the card: the base is init_params(seed 0), as in train()
    mode = checkpoint_overlay_mode(ckpt)
    loaded, n = load_checkpoint_auto(
        ckpt, load_or_init_params("small", cfg, None, device=dev))
    flat = flatten_params(loaded)
    n_dec = sum(k.startswith("decoder.") for k in ckpt_flat)
    same = sorted(flat) == sorted(ckpt_flat) and all(
        flat[k].device == dev and torch.equal(flat[k].cpu(), ckpt_flat[k])
        for k in ckpt_flat)
    del loaded, flat
    log(f"[entry loader] auto overlay mode from training_config.json: "
        f"{'full' if mode else 'decoder-only'}; {n} tensors overlaid "
        f"(decoder {n_dec}); the loaded tree equals the checkpoint's tensors "
        f"bit for bit on the card {same}")
    require(mode is False and n == n_dec and same,
            "decoder-only auto overlay reproduces the checkpoint")

    t0 = time.time()
    results = evaluate_model.main([
        "--skip-base", "--base-model", "small", "--checkpoint", ckpt,
        "--test-data", data, "--num-samples", "0"])
    log(f"[entry evaluate_model] {len(results['hypotheses'])} samples, f32, "
        f"batch 8, in {time.time() - t0:.1f} s: PER {results['per']:.2f}%, "
        f"PFER {results['pfer']:.2f}%")
    require(len(results["hypotheses"]) == TRAIN_BATCH
            and np.isfinite(results["per"]) and np.isfinite(results["pfer"]),
            "evaluation scored every sample")

    with open(data) as f:
        wavs = [e["audio_path"] for e in json.load(f)]
    text = transcribe_single.main(["--base-model", "small", "--checkpoint",
                                   ckpt, "--audio", wavs[0]])
    log(f"[entry transcribe_single] {wavs[0]!r}: {text!r}; equals the "
        f"evaluation's hypothesis {text == results['hypotheses'][0]}")
    require(text == results["hypotheses"][0],
            "transcribe_single text == the evaluation's hypothesis")

    long_path = os.path.join(os.path.dirname(data), "long40.wav")
    write_wav(long_path, synthetic_audio(1, 40.0, seed=20)[0])
    bodies = {}
    for name, path in (("short", wavs[1]), ("long", long_path)):
        with open(path, "rb") as f:
            bodies[name] = f.read()
    use_merged_attention(True)
    try:
        server, service = serve_cli.build_server([
            "--model", "small", "--checkpoint", ckpt, "--batch-size", "4",
            "--port", "0"])
        url = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        for fn in counters().values():
            fn.launches = 0
        thread.start()
        try:
            health = _http(f"{url}/healthz")
            short = _http(f"{url}/transcribe", bodies["short"])[0]
            stream = _http(f"{url}/transcribe_stream", bodies["long"])
            stats = _http(f"{url}/stats")[0]
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        by_path["HTTP service merged"] = launches
        require(not thread.is_alive() and not service._thread.is_alive(),
                "server and service threads stopped")

        def expected(windows):
            group = [pad_or_trim(w) for w in windows]
            group += [np.zeros(N_SAMPLES, np.float32)] * (4 - len(group))
            audio = torch.from_numpy(np.stack(group)).to(dev)
            with torch.inference_mode():
                mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
            res = decode(service.params, cfg, mel, service.options,
                         tokenizer=service.tokenizer)
            return [r.text for r in res[:len(windows)]]

        want_short = expected([load_audio_bytes(bodies["short"])])
        long_audio = load_audio_bytes(bodies["long"])
        want_long = expected([long_audio[:N_SAMPLES], long_audio[N_SAMPLES:]])
    finally:
        use_merged_attention(False)
    kinds = [next(iter(line)) for line in stream]
    partials = [line["partial"]["text"] for line in stream[:-1]]
    log(f"[entry serve] HTTP on 127.0.0.1, batch 4, merged attention: healthz "
        f"{health}; /transcribe {short['text']!r}; /transcribe_stream lines "
        f"{kinds}; stats {stats}; texts equal decode()'s "
        f"{[short['text']] == want_short and partials == want_long}; launches "
        f"{ {k: c for k, c in launches.items() if c} }")
    require(health == [{"status": "ok"}], "/healthz")
    require(kinds == ["partial", "partial", "final"], "two partials, then final")
    require([short["text"]] == want_short and partials == want_long
            and stream[-1]["final"]["text"] == "".join(want_long),
            "the server's texts equal decode()'s")
    require(stats == {"requests": 2, "batches": 2, "windows": 3}, "/stats")
    require(launches["K10"] == 2 * cfg.n_audio_layer and launches["K2"] == 0,
            "K10 ran the service's encoder (once a layer a batch), K2 not")
    log(f"[entry points] phase passed in {time.time() - t_phase:.1f} s")


def phase_train(torch, dev, tok, root: str, by_path):
    """Both fine-tuning modes through train(), the loop's validation and
    the inference entry points on the decoder-only checkpoint, then save
    and resume. Each run's directory goes once it has been read (a
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
            phase_entry_points(torch, dev, cfg, data, out, final, by_path)
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
        ("K9 stochastic_quantize_int8_many", check_sr_quant,
         "whisper_ipa_torch/csrc/sr_quant.cu",
         "whisper_ipa_tpu/ops/sr_quant.py:94"),
        ("K10 fused_attention_merged", check_merged_attention,
         "whisper_ipa_torch/csrc/attention.cu",
         "whisper_ipa_tpu/ops/attention.py:383"),
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
    phase_merged_path(torch, dev, cfg, params, tok, by_path, default_results)
    k9_tree = phase_quantized_paths(torch, dev, cfg, params, tok, by_path,
                                    default_results)
    phase_parity(torch, dev, tok)
    phase_service(torch, dev, cfg, params, tok)
    phase_service(torch, dev, cfg, params, tok, quant_bits=4, kv_int4=True)
    del params
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trained = phase_train(torch, dev, tok, root, by_path)
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
        if key == "K9":
            k.update(k9_tree)
        k["launches_by_path"] = {p: c[key] for p, c in by_path.items() if c[key]}
        k["launches"] = sum(k["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in order}, **{k: v for k, v in e.items() if k not in order}}
        for e in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
