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
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


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


def counters():
    from whisper_ipa_torch.ops import attention, decode_attention, mel_kernel

    return {
        "K1": mel_kernel.log_mel_power,
        "K2": attention.fused_attention,
        "K4": decode_attention.decode_cross_attention_int8_tminor,
        "K5": attention.attention_backward,
    }


def synthetic_audio(batch: int, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, int(seconds * SAMPLE_RATE))) * 0.1
            ).astype(np.float32)


def phase_main_path(torch, dev, cfg, params, tok):
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    options = DecodingOptions(
        language="en", without_timestamps=True, sample_len=MAIN_SAMPLE_LEN,
        suppress_tokens=[-1, tok.eot],  # every row decodes all 64 tokens
        fp16=True, kv_int8=True,
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

    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    mel, results = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    walls = [wall]
    for _ in range(2):  # the spread, outside the counted run
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)

    require(bool(torch.isfinite(mel).all()), "log-mel finite")
    require(len(results) == MAIN_BATCH, "one result per row")
    for r in results:
        require(len(r.tokens) == MAIN_SAMPLE_LEN, f"{len(r.tokens)} tokens")
        # avg_logprob and no_speech_prob are read off the logits
        require(np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob),
                "finite logits")
    for name in ("K1", "K2", "K4"):
        require(launches[name] > 0, f"{name} launched on the main path")
    audio_s = MAIN_BATCH * 30.0
    log(f"[main path] whisper-small bf16 int8 cross-KV, batch {MAIN_BATCH} x "
        f"30 s, {MAIN_SAMPLE_LEN} tokens/row: wall {wall:.3f} s "
        f"({audio_s / wall:.1f} audio-s/s); runs {[round(w, 4) for w in walls]} s; "
        f"warm-up run {warm:.2f} s; peak device memory {peak_gb:.2f} GB; "
        f"launches {launches}")
    return launches


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


def phase_service(torch, dev, cfg, params, tok):
    from whisper_ipa_torch.audio import N_SAMPLES, pad_or_trim
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.serve import TranscriptionService

    seconds = [5.0, 12.0, 40.0, 8.0, 20.0, 3.0]  # the third spans 2 windows
    clips = [synthetic_audio(1, s, seed=10 + i)[0] for i, s in enumerate(seconds)]
    svc = TranscriptionService(params, cfg, device=dev, batch_size=4,
                               max_wait_ms=1000.0, tokenizer=tok)
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
        ref.extend(decode(params, cfg, mel, svc.options, tokenizer=tok))
    segs = [seg for o in outs for seg in o["segments"]]
    require(len(segs) == 7, f"7 windows answered, got {len(segs)}")
    for seg, r in zip(segs, ref):
        require(seg["text"] == r.text, "service text == decode() text")
        require(abs(seg["avg_logprob"] - r.avg_logprob) < 1e-3,
                "service avg_logprob == decode() avg_logprob")
    lat = [round(o["latency_sec"], 3) for o in outs]
    log(f"[service] 6 requests ({seconds} s audio) resolved, texts and "
        f"avg_logprobs equal decode() on the same windows; latencies s {lat}; "
        f"stats {stats}")


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
        ("K4 decode_cross_attention_int8_tminor", check_decode_attention,
         "whisper_ipa_torch/csrc/decode_attention.cu",
         "whisper_ipa_tpu/ops/decode_attention.py:112"),
        ("K5 attention_backward", check_attention_backward,
         "whisper_ipa_torch/csrc/attention_bwd.cu",
         "whisper_ipa_tpu/ops/attention.py:216"),
    ):
        entry = check(torch, dev)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **entry))

    cfg = CONFIGS["small"]
    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    params = init_params(cfg, seed=0, device=dev)
    by_path = {"serving": phase_main_path(torch, dev, cfg, params, tok)}
    phase_parity(torch, dev, tok)
    phase_service(torch, dev, cfg, params, tok)
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

    # launches: the sum over the counted runs of each path (serving, the
    # two training modes), with the per-path counts beside it
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
