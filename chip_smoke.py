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
            resume on the card; decoder-only again with steps_per_call 4
            (chunks 4, 4, 2), its losses and checkpoint equal to one step
            a call; train_step and a train_chunk under sync-debug "error"
            (no host sync), and a step's syncs counted with the
            optimizer's scalars copied from the host; a test-tiny
            trajectory on CUDA against the CPU
  kernel A/B  cli.bench_decode_kernel (plain against K4, and K8 on the
            int4 cache) and cli.bench_quant_decode (f32, int8, int4,
            int4-kernel), short; each arm's launches and device kernels
            read apart: K4/K8 only in the kernel arm, K7 only in
            int4-kernel
  entry points, on the decoder-only run's checkpoint: the checkpoint
            loader, cli.evaluate_model, cli.transcribe_single, and the
            HTTP server of cli.serve (merged attention on: K10 in the
            service) with its texts against decode(); then
            cli.evaluate_model --beam-size 5, cli.transcribe --bf16 --json
            and cli.serve --beam-size 2
  decoding, at whisper-small bf16: decode() on the default
            DecodingOptions (the timestamp grammar, checked on the host)
            with the int8 (K4) and the int4 (K8) cross cache, best-of-3
            sampling; beam 5 at batch 4, timestamps off and on, int8 and
            float cache (the beam loop's J queries take the plain path, as
            in the reference: no K4); transcribe() of 75 s, batched and
            sequential-timestamps, with phone timestamps; test-tiny beam
            tokens on CUDA against the CPU
  learning  examples/generalization.py's recipe on the card: 256 synthetic
            utterances (data.synth, WAVs, the mel cache filled by K1),
            whisper-tiny at full width from random init trained 600 steps
            through train() (encoder unfrozen: K2 forward, K5 backward),
            held-out PER/PFER at steps 200, 400, 600 against a random
            floor; then on the checkpoint cli.evaluate_model greedy and
            beam 5, an int8-cache decode (K4), cli.error_analysis, the
            phone-timestamp oracle against the synthesizer's boundaries,
            transcribe() of 45-60 s batched and sequential, and the held-out
            split under noise and reverb
  engine    the in-flight engine (serve_continuous): test-tiny tokens on
            CUDA equal to the CPU engine's and decode()'s; at whisper-small,
            16 slots, bf16, int8 cache, a seeded stream of 24 requests
            20-60 ms apart (one cancelled, one with a 0.2 s deadline), each
            window's tokens held to decode() on its K1 log-mel under the
            near-tie rule, K1/K2/K4 launches equal to the prediction from
            the engine's joins and steps; the stream again with joins that
            rewrite the joiners' rows only, adaptive, in f32 and with int4
            weights (K7); the join rewrite's drift; cli.serve --continuous
            over HTTP, with 503s past --max-pending
  speculative decoding at whisper-small on the serving batch (bf16, int8
            cache, K 4): a self-draft, a whisper-tiny draft (16 tokens a
            row), n-gram, a Medusa chain and tree (in the engine the same
            five and the tree at 32 slots, the drafts on 8 requests),
            each held to decode() under the near-tie rule, K1/K2 launches as predicted and no K4 (the
            verify blocks are multi-query); the self-draft in f32; the
            drift of the tree's re-fed K/V rows in bf16 and f32; the
            verify forward's device time; test-tiny CUDA against the CPU;
            on the learning phase's checkpoint, cli.train_medusa and
            cli.distill_draft (K2 forward, K5 backward), the trained and
            untrained drafts on the held-out split, and cli.serve
            --draft-model ngram (plain, as the reference's service) and
            medusa --medusa-tree over HTTP
  data preparation (host, on a machine without pandas or openpyxl):
            cli.check_vocab; cli.prepare_datasets g2p on a seeded
            CommonVoice-style fixture of the seven G2P languages (every
            filter's case, synthesized clips of 1-8 s), its per-language
            counts against a prediction made from the fixture; verify;
            timit, metu, ogi and combine on one-utterance layouts
  zero-shot on the learning phase's held-out split: annotator sheets
            written by utils.xlsx, cli.parse_zeroshot_test, cli.compute_iaa
            against evaluate_batch, cli.evaluate_zeroshot on the whisper-tiny
            checkpoint (K1 a utterance; f32, so no K2) and at its default
            base model, large-v3 at random init, each hypothesis equal to
            decode()'s on the same log-mels
  tools     cli.benchmark_models (parameter counts; --measure: the f32
            frozen-encoder step at tiny and small with MFU),
            cli.profile_inference (decode at whisper-small, bf16, int8
            cache: K1, K2, K4; the train step, with cached features, and at
            tiny), each port kernel's launches as predicted, and
            cli.calculate_real_speed on the learning run and its console
  examples  the port's example programs (examples/torch_*.py), whose data
            set and perturbations the learning phase uses, through their
            mains on the learning checkpoint: the per-locale report, the
            unseen-speaker and snr10+reverb conditions, the latency probe
            at whisper-small, the minimal fine-tune, and corpus_scale's
            three stages on a small corpus in the reference's schema
  parallel  whisper_ipa_torch.parallel on the one card: a one-rank NCCL
            group and the collective helpers on CUDA tensors; then two
            ranks sharing the card over gloo (spawned after every kernel
            is built): TP=2 greedy decoding at the serving setting (K2
            and K4 on 6 local heads; tokens held to the one-rank run
            under the near-tie rule), decoder-only DP=2, ZeRO-1 and FSDP
            steps at global batch 12 (one chunk of 2 steps each, its
            rows cut by shard_chunk) and a TP=2 full fine-tune step (K5
            on 6 local heads), each against the one-rank run, with each
            rank's launches and local shapes; then the in-flight engine
            at TP=2 (also with adaptive sync, whose long chunks the
            all-halted check stops at the same step on both ranks), at
            DP=2 (4 slots a rank) and at TP=2 with a Medusa tree, and the service's whisper-tiny draft speculation at
            TP=2, on a seeded stream of 6 requests, each held to decode()
            under the near-tie rule beside the engine alone on one rank,
            launches as predicted from each rank's installs, steps and
            batches; K2, K4 and K5 held to their plain versions at those
            shapes in each rank

make -C native builds the host library of the edit-distance and WAV
cores first (the metrics take their NumPy paths where it does not build;
the log says which ran). Each path's kernel launch counts are set to 0 just before it and read just
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


def build_native() -> dict:
    """``make -C native``: the host library of the edit-distance and WAV
    cores (metrics/native.py, audio/native.py). Run before the port is
    imported, since its metric modules bind the library at import; where it
    does not build, the metrics and the WAV reader take their NumPy paths
    (the reference's own fallback), and phase_learn logs which one ran."""
    native = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
    t0 = time.time()
    try:
        out = subprocess.run(["make", "-C", native], capture_output=True,
                             text=True, timeout=300)
        rc, err = out.returncode, out.stderr.strip()[-400:]
    except (OSError, subprocess.TimeoutExpired) as e:
        rc, err = None, str(e)
    return dict(rc=rc, seconds=time.time() - t0, error=err if rc else "")


def phase_build(native: dict):
    from whisper_ipa_torch.metrics import per

    log(f"[build native] make -C native: rc {native['rc']} in "
        f"{native['seconds']:.1f} s{'; ' + native['error'] if native['error'] else ''}"
        f"; the port's PER uses the native core "
        f"{per._native_levenshtein is not None}")
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
    # values that differ in the last bits. Whisper-small's 12 heads,
    # whisper-tiny's 6 as phase_learn trains it (bf16, batch 16), the
    # test-tiny student cli.distill_draft trains (2 heads of width 32), and
    # cli.evaluate_zeroshot's f32 encoders (whisper-tiny at batch 8,
    # large-v3's 20 heads at batch 4), which take K2 under
    # use_fused_attention(True) (by default f32 takes the plain path)
    for batch, heads, dh, dtype, tol in (
        (MAIN_BATCH, 12, 64, torch.bfloat16, 5e-3),
        (MAIN_BATCH, 12, 64, torch.float32, 2e-5),
        (MAIN_BATCH, 12, 32, torch.bfloat16, 5e-3),
        (MAIN_BATCH, 12, 32, torch.float32, 2e-5),
        (MAIN_BATCH, 6, 64, torch.bfloat16, 5e-3),
        (MAIN_BATCH, 2, 32, torch.bfloat16, 5e-3),
        (8, 6, 64, torch.float32, 2e-5),
        (4, 20, 64, torch.float32, 2e-5),
    ):
        q, k, v = (
            torch.randn((batch, heads, 1500, dh), generator=gen,
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
        log(f"[K2 attention] ({batch}*{heads}, 1500, {dh}) "
            f"{str(dtype)[6:]}: "
            f"max|kernel-plain| {err:.3e} (bound {tol:g}); vs f32 on the "
            f"same inputs: kernel {max_abs(got, exact):.3e}, plain "
            f"{max_abs(want, exact):.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        ok = bf16_within(got, want, tol) if dtype == torch.bfloat16 else err < tol
        require(ok, f"K2 H={heads} dh={dh} {dtype} within {tol}")
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


def device_profile(torch, fn, iters: int = 50, attempts: int = 5,
                   lost: float = 0.0):
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
    raises. ``lost``: the share of a window's records that may be missing
    (or extra) for its time to be taken as it is (an informative timing
    where one dropped microsecond kernel changes nothing)."""
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
        off = min(count % iters, iters - count % iters)
        if off <= lost * count:
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

    def codes(b=B, h=H):
        c = torch.randint(-127, 128, (b, h, Dh, T_pad), generator=gen, device=dev)
        return c.to(torch.int8).contiguous()

    def scales(b=B, h=H):
        s = 0.01 + 0.02 * torch.rand((b, h, T_pad), generator=gen, device=dev)
        s[..., T:] = 0.0  # padded positions
        return s.contiguous()

    def held(q, k, ks, v, vs):
        """One launch against the plain version: (output, plain output,
        error, within the bound, the bound). Bounds: f32 rtol/atol 1e-5;
        bf16 q 2% of the largest output: the plain version rounds its
        logits and weighted probabilities to bf16."""
        before = da.decode_cross_attention_int8_tminor.launches
        got = da.decode_cross_attention_int8_tminor(q, k, ks, v, vs)
        torch.cuda.synchronize()
        require(
            da.decode_cross_attention_int8_tminor.launches == before + 1,
            "K4 counter rose",
        )
        want = da.decode_attention_plain(q, k, ks, v, vs)
        require(got.shape == q.shape and got.dtype == q.dtype,
                "K4 shape/dtype")
        err = max_abs(got, want)
        scale = float(want.float().abs().max())
        if q.dtype == torch.float32:
            return (got, want, err, torch.allclose(got, want, rtol=1e-5,
                                                   atol=1e-5),
                    "rtol=atol=1e-5")
        return (got, want, err, err <= 0.02 * scale,
                f"2% of max|out| = {0.02 * scale:.3e}")

    k, ks, v, vs = codes(), scales(), codes(), scales()
    q32 = torch.randn((B, H, 1, Dh), generator=gen, device=dev) * Dh ** -0.5
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        q = q32.to(dtype)
        got, want, err, ok, tol = held(q, k, ks, v, vs)
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

    # whisper-tiny's 6 heads, as phase_learn decodes with the int8 cache:
    # 16 held-out utterances a batch, transcribe()'s two windows batched
    # and one window at a time; its params are f32
    row = []
    for batch in (LEARN_BATCH, 2, 1):
        cache = (codes(batch, 6), scales(batch, 6), codes(batch, 6),
                 scales(batch, 6))
        q6 = torch.randn((batch, 6, 1, Dh), generator=gen,
                         device=dev) * Dh ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            _, _, err, ok, tol = held(q6.to(dtype), *cache)
            row.append(f"B={batch} q {str(dtype)[6:]} {err:.3e} ({tol})")
            require(ok, f"K4 B={batch} H=6 q {dtype} within bound")
    log("[K4 decode attention] H=6 Dh=64 T_pad=1536 (whisper-tiny): "
        "max|kernel-plain| " + "; ".join(row))

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
    T = 1500
    entry = None
    # bounds, relative to max|grad|: f32 1e-4 (the CPU tests hold the plain
    # version to the TPU kernel at 1e-5; here the kernel sums 1500 terms in
    # another order than cuBLAS); bf16 1e-2: both sides round P and dS to
    # bf16 before their products (one ulp 2^-8 relative) at values that
    # differ in the last bits. Whisper-small fine-tuned at batch 12 with 12
    # heads, whisper-tiny as phase_learn trains it (batch 16, 6 heads), and
    # the test-tiny student cli.distill_draft trains (batch 16, 2 heads of
    # width 32)
    for B, H, dh, dtype, tol in (
        (TRAIN_BATCH, 12, 64, torch.bfloat16, 1e-2),
        (TRAIN_BATCH, 12, 64, torch.float32, 1e-4),
        (TRAIN_BATCH, 12, 32, torch.bfloat16, 1e-2),
        (TRAIN_BATCH, 12, 32, torch.float32, 1e-4),
        (LEARN_BATCH, 6, 64, torch.bfloat16, 1e-2),
        (LEARN_BATCH, 2, 32, torch.bfloat16, 1e-2),
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
        require(max(rel) < tol, f"K5 ({B}*{H}) dh={dh} {dtype} within {tol}")
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


def reset_counts(torch):
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0


def read_counts(torch) -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters().items()}


def nonzero(counts: dict) -> dict:
    return {k: c for k, c in counts.items() if c}


def example(name: str):
    """examples/<name>.py of this checkout, loaded by path (the port's
    example programs: the learning phase takes its data set and
    perturbations from them, phase_examples runs their mains)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
        reset_counts(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        mel, results = run()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        per_run.append(read_counts(torch))
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

    reset_counts(torch)
    t0 = time.time()
    d8 = sr.quantize_params_device(params)
    launches = by_path["device quantize int8"] = read_counts(torch)
    wall = time.time() - t0
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
    # one linear through quantize_linear_device (the reference's
    # single-weight entry): K9 once, equal to the plain version
    lin = params["decoder"]["blocks"][0]["mlp1"]
    reset_counts(torch)
    one = sr.quantize_linear_device(lin, seed=5)
    by_path["device quantize linear"] = read_counts(torch)
    one_launches = nonzero(by_path["device quantize linear"])
    want_q, want_s = sr.stochastic_quantize_int8_plain(lin["w"], 5)
    log(f"[device quantize linear] quantize_linear_device of decoder block "
        f"0's mlp1 {tuple(lin['w'].shape)}: keys {sorted(one)}, equal to the "
        f"plain version {torch.equal(one['w_q'], want_q) and torch.equal(one['w_s'], want_s)}"
        f"; launches {one_launches}")
    require(sorted(one) == sorted(set(lin) - {"w"} | {"w_q", "w_s"})
            and torch.equal(one["w_q"], want_q)
            and torch.equal(one["w_s"], want_s) and one_launches == {"K9": 1},
            "quantize_linear_device: K9 once, equal to the plain version")
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

    # beam search (the reorder-free loop), timestamps off and on, with
    # hypotheses finishing into the pool (every id but 0-5 suppressed)
    for ts in (False, True):
        opts = DecodingOptions(language="en", without_timestamps=not ts,
                               sample_len=8, beam_size=3, length_penalty=1.0,
                               suppress_tokens=list(range(6, tok.eot)),
                               suppress_blank=False, kv_int8=True)
        gpu = decode(gpu_params, cfg, mel, opts, tokenizer=tok)
        cpu = decode(cpu_params, cfg, mel, opts, tokenizer=tok)
        same = [a.tokens == b.tokens for a, b in zip(gpu, cpu)]
        lp = max(abs(a.avg_logprob - b.avg_logprob) for a, b in zip(gpu, cpu))
        log(f"[parity] test-tiny f32 beam 3, timestamps {ts}, int8 cross-KV, "
            f"2 rows x 8 tokens: CUDA == CPU tokens per row {same} "
            f"({[a.tokens for a in gpu]}); max |avg_logprob diff| {lp:.2e} "
            f"(bound 1e-4)")
        require(all(same) and lp < 1e-4,
                "test-tiny beam tokens identical on CUDA and CPU")

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


# -- the in-flight engine (serve_continuous) --------------------------------

ENGINE_SLOTS = 16
ENGINE_MAX_NEW = 64
ENGINE_REQUESTS = 24  # the stream at the CLI's setting (bf16, int8 cache):
# enough to fill the 16 slots and queue the request with the deadline
EPS_WINDOWS = 16  # windows whose step-0 logits set the bf16 near-tie bound
ENGINE_CANCEL = 7  # cancelled right after its submit
ENGINE_DEADLINE = 21  # submitted with a 0.2 s deadline
EPS_F32 = 1e-3  # near-tie bound on decode()'s two top logits in f32


def engine_stream(n: int, seed: int = 30):
    """n seeded noise clips of 5-40 s (those past 30 s chain two windows)
    and the seeded 20-60 ms gaps between their arrivals."""
    rng = np.random.default_rng(seed)
    seconds = rng.uniform(5.0, 40.0, n)
    gaps = rng.uniform(0.020, 0.060, n)
    clips = [synthetic_audio(1, float(s), seed=seed + 1 + i)[0]
             for i, s in enumerate(seconds)]
    return clips, gaps


class JoinDrift:
    """Wraps ``serve_continuous._join_step`` while an engine runs. For each
    slot that re-feeds at a join (a request in flight, pos > 0) it reads the
    rows [pos, pos + P - 1) of the self K/V before and after: they held the
    K/V the chunks wrote, and the join writes them again from the same
    tokens at M = slots * P rows (row pos + P - 1, the newest token's, is a
    first write). ``restore`` puts the old rows back after each join, which
    is a join that rewrites the joiners' rows only."""

    def __init__(self, sc, eng, restore: bool = False):
        self.sc, self.eng, self.restore = sc, eng, restore
        self.events = self.rows = self.changed = 0
        self.max_dk = self.max_dv = 0.0

    def __enter__(self):
        self.orig = self.sc._join_step
        self.sc._join_step = self.step
        return self

    def __exit__(self, *exc):
        self.sc._join_step = self.orig
        self.slots = len(self.eng._slots)
        self.eng = None  # the engine's cache is freed with the engine

    def step(self, params, cfg, cache, tokens, pos, dtype, tp=None):
        n = tokens.shape[1] - 1
        starts = pos.tolist()
        saved = [(b, p, cache.self_k[:, b, p:p + n].clone(),
                  cache.self_v[:, b, p:p + n].clone())
                 for b, p in enumerate(starts)
                 if p > 0 and self.eng._slots[b] is not None]
        cache = self.orig(params, cfg, cache, tokens, pos, dtype=dtype, tp=tp)
        for b, p, k, v in saved:
            dk = float((cache.self_k[:, b, p:p + n].float() - k.float()).abs().max())
            dv = float((cache.self_v[:, b, p:p + n].float() - v.float()).abs().max())
            self.max_dk, self.max_dv = max(self.max_dk, dk), max(self.max_dv, dv)
            self.rows += n
            self.changed += bool(dk or dv)
            if self.restore:
                cache.self_k[:, b, p:p + n] = k
                cache.self_v[:, b, p:p + n] = v
        self.events += 1
        return cache

    def summary(self) -> str:
        return (f"{self.events} joins, {self.rows} re-fed rows in "
                f"{self.slots} slots: max |dK| {self.max_dk:.3e}, "
                f"|dV| {self.max_dv:.3e}, slots changed {self.changed}")


def run_engine(torch, dev, eng, clips, gaps, cancel=None, deadline=None):
    """Submit the stream at its gaps, wait for every answer; the launches
    are counted from 0 just before the first submit. Returns the results
    (None where cancelled), each request's tokens by window (from
    on_token), wall, launches, stats, peak GB."""
    reset_counts(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    futs, streamed = [], []
    t0 = time.time()
    for i, (clip, gap) in enumerate(zip(clips, gaps)):
        by_window = {}

        def on_token(d, by_window=by_window):
            by_window.setdefault(d["window"], []).append(d["token"])

        fut = eng.submit(clip, on_token=on_token,
                         deadline_sec=0.2 if i == deadline else None)
        if i == cancel:
            require(fut.cancel(), "a request in the queue cancels")
        futs.append(fut)
        streamed.append(by_window)
        time.sleep(float(gap))
    results = [None if f.cancelled() else f.result(timeout=600) for f in futs]
    wall = time.time() - t0
    launches = read_counts(torch)
    return dict(results=results, streamed=streamed, wall=wall,
                launches=launches, stats=eng.stats(),
                peak=torch.cuda.max_memory_allocated(dev) / 1e9)


def engine_windows(clips):
    from whisper_ipa_torch.audio import N_SAMPLES, pad_or_trim

    return [((i, w), pad_or_trim(c[s:s + N_SAMPLES]))
            for i, c in enumerate(clips)
            for w, s in enumerate(range(0, len(c), N_SAMPLES))]


def engine_oracle(torch, dev, cfg, params, tok, clips, bf16: bool):
    """decode() of every window of the stream on its K1 log-mel (the
    engine's options: greedy, no timestamps, 64 tokens, the int8 cache);
    returns ({(request, window): tokens}, {(request, window): mel})."""
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    keys, windows = zip(*engine_windows(clips))
    audio = torch.from_numpy(np.stack(windows)).to(dev)
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    options = DecodingOptions(language="en", without_timestamps=True,
                              sample_len=ENGINE_MAX_NEW, fp16=bf16,
                              kv_int8=True)
    results = decode(params, cfg, mel, options, tokenizer=tok)
    return ({k: r.tokens for k, r in zip(keys, results)},
            {k: mel[j:j + 1] for j, k in enumerate(keys)})


def forced_logits(torch, cfg, params, mel, seq, dtype):
    """decode()'s next-token logits after ``seq`` (prefix + tokens) on one
    window, teacher-forced in one block (float32, before the masks)."""
    from whisper_ipa_torch.models import (cast_decoder_blocks, decode_step,
                                          encode, init_cache)

    with torch.inference_mode():
        p = cast_decoder_blocks(params, dtype)
        feats = encode(params, cfg, mel, dtype=dtype)
        cache = init_cache(p, cfg, feats, max_len=len(seq), dtype=dtype,
                           cross_kv_int8=True)
        tokens = torch.tensor([seq], device=mel.device)
        logits, _ = decode_step(p, cfg, tokens, cache, 0, dtype=dtype)
    return logits[0, -1].float()


def step0_delta(torch, cfg, params, mels, prefix) -> float:
    """max |logit(bf16) - logit(f32)| at decode()'s first sampled position
    over these windows: the bf16 oracle's near-tie bound is twice it."""
    from whisper_ipa_torch.models import (cast_decoder_blocks, decode_step,
                                          encode, init_cache)

    mel = torch.cat(mels)
    out = []
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            p = cast_decoder_blocks(params, dtype)
            feats = encode(params, cfg, mel, dtype=dtype)
            cache = init_cache(p, cfg, feats, max_len=len(prefix), dtype=dtype,
                               cross_kv_int8=True)
            tokens = torch.tensor([prefix] * len(mels), device=mel.device)
            logits, _ = decode_step(p, cfg, tokens, cache, 0, dtype=dtype)
            out.append(logits[:, -1].float())
    return float((out[0] - out[1]).abs().max())


def hold_to_decode(torch, cfg, params, tok, rows, prefix, suppress, blank,
                   dtype, eps: float, name: str):
    """The near-tie rule, row by row: a path's tokens equal decode()'s, or
    at their first difference decode()'s choice leads the path's by at
    most eps in decode()'s own (teacher-forced, masked) logits. ``rows``:
    (label, tokens, decode()'s tokens, the row's (1, frames, n_mels) mel,
    whether the path may stop early); ``prefix``, ``suppress``, ``blank``
    and ``dtype``: decode()'s. Returns (rows equal, rows diverged at a
    near-tie, the gaps there)."""
    equal, gaps = 0, []
    for label, got, want, mel, may_stop in rows:
        if got == want or (may_stop and got == want[:len(got)]):
            equal += 1
            continue
        k = next(j for j in range(min(len(got), len(want)) + 1)
                 if j == len(got) or j == len(want) or got[j] != want[j])
        dec = want[k] if k < len(want) else tok.eot
        mine = got[k] if k < len(got) else tok.eot
        lg = forced_logits(torch, cfg, params, mel, list(prefix) + want[:k],
                           dtype)
        lg = lg + suppress + (blank if k == 0 else 0.0)
        gap = float(lg[dec] - lg[mine])
        gaps.append(round(gap, 6))
        require(gap <= eps, f"{name}: {label} leaves decode() at token {k} "
                f"({mine} for {dec}) by {gap:.3e} > {eps:.3e}, not a near-tie")
    return equal, len(gaps), gaps


def check_engine_tokens(torch, cfg, params, tok, eng, run, oracle, mels,
                        eps: float, name: str):
    """``hold_to_decode`` over the engine's windows (``eng``: the engine
    that ran, for its prefix, masks and dtype); a timed-out request may
    stop early, a cancelled one is left out."""
    rows = [(f"request {i} window {w}", run["streamed"][i].get(w, []), want,
             mels[(i, w)], run["results"][i]["timed_out"])
            for (i, w), want in oracle.items() if run["results"][i] is not None]
    return hold_to_decode(torch, cfg, params, tok, rows, eng.prefix,
                          eng.suppress, eng.blank, eng.dtype, eps, name)


def engine_numbers(run) -> dict:
    done = [r for r in run["results"] if r is not None]
    ttft = sorted(r["ttft_sec"] for r in done if r["ttft_sec"] is not None)
    queue = sorted(r["queue_sec"] for r in done if r["queue_sec"] is not None)
    emitted = sum(len(r["tokens"]) for r in done)
    pick = lambda xs, q: round(float(np.quantile(xs, q)), 4) if xs else None
    s = run["stats"]
    return dict(wall_s=round(run["wall"], 4), tokens=emitted,
                tokens_per_s=round(emitted / run["wall"], 1),
                ttft_p50=pick(ttft, 0.5), ttft_p90=pick(ttft, 0.9),
                queue_p50=pick(queue, 0.5), chunks=s["chunks"],
                fast_chunks=s["fast_chunks"], long_chunks=s["long_chunks"],
                steps=s["steps"], joins=s["joins"], peak_gb=round(run["peak"], 2))


def expect_launches(cfg, run, bf16: bool, name: str) -> dict:
    """K1 once a joined window, K2 once an encoder layer of one (bf16),
    K4 once a decoder layer a chunk step (the join's n_prefix queries take
    the plain path)."""
    joins, steps = run["stats"]["joins"], run["stats"]["steps"]
    want = {"K1": joins, "K2": cfg.n_audio_layer * joins if bf16 else 0,
            "K4": cfg.n_text_layer * steps}
    got = {k: run["launches"][k] for k in want}
    positive = ("K1", "K2", "K4") if bf16 else ("K1", "K4")
    require(got == want and all(got[k] for k in positive),
            f"{name}: launches {got}, predicted {want}")
    return got


def phase_engine_parity(torch, dev, tok, modes=(("plain", {}),)):
    """test-tiny in f32 with the int8 cache: six requests, some of two
    windows, through 2 slots on the card, on the CPU, and decode(); once
    for each (name, engine keywords) of ``modes``. K4 runs on the card
    where the engine takes single-query steps over the int8 cache (the
    plain engine's steps, a draft model's)."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher

    cfg = replace(CONFIGS["test-tiny"], n_text_ctx=48)
    params = init_params(cfg, seed=0)
    clips, _ = engine_stream(6, seed=60)
    keys, windows = zip(*engine_windows(clips))
    audio = torch.from_numpy(np.stack(windows)).to(dev)
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    res = decode(params_to(params, dev), cfg, mel,
                 DecodingOptions(language="en", without_timestamps=True,
                                 sample_len=16, kv_int8=True), tokenizer=tok)
    want = [[] for _ in clips]
    for (i, _), r in zip(keys, res):
        want[i] += r.tokens
    for mode, kw in modes:
        kw = kw(cfg) if callable(kw) else kw
        out = {}
        for device in ("cpu", dev):
            eng = ContinuousBatcher(params, cfg, device=device, slots=2,
                                    max_new_tokens=16, steps_per_sync=2,
                                    kv_int8=True, tokenizer=tok, **kw)
            try:
                k4 = counters()["K4"].launches
                futs = []
                for c in clips:
                    futs.append(eng.submit(c))
                    time.sleep(0.01)
                out[str(device)] = [f.result(timeout=600)["tokens"]
                                    for f in futs]
                ran = counters()["K4"].launches - k4
            finally:
                eng.close()
        same = [a == b == c for a, b, c in zip(out["cpu"], out[str(dev)], want)]
        single_query = not kw or kw.get("draft_params") is not None
        log(f"[engine parity {mode}] test-tiny f32 int8 cross-KV, 6 requests "
            f"({len(keys)} windows) through 2 slots: CUDA == CPU == decode() "
            f"tokens per request {same}; K4 on CUDA {ran}")
        require(all(same) and (ran > 0) == single_query,
                f"test-tiny engine ({mode}) tokens equal on CUDA, on the CPU "
                f"and decode()'s, K4 {ran}")


def check_stream(run, name: str, deadline=ENGINE_DEADLINE):
    """Every future resolved; the cancelled request and the one with the
    0.2 s deadline (``deadline``; None for a stream cut before it) are
    the only ones cancelled and timed out."""
    results, stats = run["results"], run["stats"]
    timed_out = [i for i, r in enumerate(results) if r and r["timed_out"]]
    want = [] if deadline is None else [deadline]
    require(results[ENGINE_CANCEL] is None
            and all(r is not None for i, r in enumerate(results)
                    if i != ENGINE_CANCEL), f"{name}: every future resolved")
    require(stats["cancelled"] == 1 and stats["timed_out"] == len(want)
            and timed_out == want,
            f"{name}: one cancelled, {len(want)} timed out: {stats}")


def phase_engine(torch, dev, cfg, params, tok, by_path):
    """The in-flight engine at whisper-small's full width and depth: the
    CLI's setting (bf16, int8 cross cache, 16 slots, 64 tokens, 4 steps a
    sync, join fast sync, prewarmed) on a stream of 24 requests arriving
    20-60 ms apart, one cancelled and one with a 0.2 s deadline; the same
    stream with joins rewriting the joiners' rows only, with adaptive sync
    (long chunks of 16 steps while nothing waits to join), in f32 (both
    rewrites) and with int4 weights; then cli.serve --continuous over
    HTTP. Returns the stream, its bf16 oracle, mels and near-tie bound and
    the bf16 run's numbers, for phase_engine_speculative."""
    import whisper_ipa_torch.serve_continuous as sc
    from whisper_ipa_torch.models import params_to
    from whisper_ipa_torch.ops.quant import quantize_params

    t_phase = time.time()
    phase_engine_parity(torch, dev, tok)
    clips, gaps = engine_stream(ENGINE_REQUESTS)
    n_windows = len(engine_windows(clips))

    def serve_stream(name, p, oracle, mels, eps, bf16=True, restore=False,
                     **kw):
        """One engine over the stream: launches counted, gates applied,
        tokens held to the oracle; the engine is dropped on return."""
        t0 = time.time()
        eng = sc.ContinuousBatcher(
            p, cfg, device=dev, slots=ENGINE_SLOTS,
            max_new_tokens=ENGINE_MAX_NEW, bf16=bf16, kv_int8=True,
            tokenizer=tok, prewarm=True, **kw)
        prewarm_s = time.time() - t0
        try:
            with JoinDrift(sc, eng, restore=restore) as drift:
                run = run_engine(torch, dev, eng, clips, gaps,
                                 cancel=ENGINE_CANCEL, deadline=ENGINE_DEADLINE)
        finally:
            eng.close()
        require(not eng._thread.is_alive(), f"{name}: engine thread stopped")
        check_stream(run, name)
        expected = expect_launches(cfg, run, bf16, name)
        equal, near, at = check_engine_tokens(
            torch, cfg, p, tok, eng, run, oracle, mels, eps, name)
        log(f"[{name}] {ENGINE_REQUESTS} requests, {n_windows} windows: "
            f"{engine_numbers(run)}; prewarm {prewarm_s:.2f} s; launches "
            f"{nonzero(run['launches'])}, as predicted from joins and steps "
            f"{expected}; join rewrite: {drift.summary()}; {equal} windows "
            f"equal decode()'s, {near} leave it at a near-tie (gaps {at}; "
            f"eps {eps:.4e})")
        run["join_events"] = drift.events
        return run

    def differ(a, b) -> int:
        """Requests whose tokens differ between two runs of the stream (the
        cancelled and the timed-out one left out)."""
        return sum(a["streamed"][i] != b["streamed"][i]
                   for i in range(ENGINE_REQUESTS)
                   if i not in (ENGINE_CANCEL, ENGINE_DEADLINE))

    # bf16, the CLI's setting; eps from decode()'s own bf16-f32 spread
    oracle, mels = engine_oracle(torch, dev, cfg, params, tok, clips, True)
    prefix = list(tok.sot_sequence_including_notimestamps)
    delta = step0_delta(torch, cfg, params, list(mels.values())[:EPS_WINDOWS],
                        prefix)
    eps_bf16 = 2.0 * delta
    log(f"[engine] bf16 near-tie bound: step-0 max |logit(bf16) - "
        f"logit(f32)| over {EPS_WINDOWS} windows {delta:.4e}, eps twice it")
    runs = {}
    for name, kw in (
        ("engine bf16", {}),
        ("engine bf16 joiners-only rewrite", dict(restore=True)),
        ("engine bf16 adaptive", dict(adaptive_sync=True)),
    ):
        runs[name] = serve_stream(name, params, oracle, mels, eps_bf16, **kw)
    by_path["engine bf16"] = runs["engine bf16"]["launches"]
    require(runs["engine bf16 adaptive"]["stats"]["long_chunks"] > 0,
            "engine bf16 adaptive: long chunks ran")

    f32_oracle, f32_mels = engine_oracle(torch, dev, cfg, params, tok, clips,
                                         False)
    for name, kw in (("engine f32", {}),
                     ("engine f32 joiners-only rewrite", dict(restore=True))):
        runs[name] = serve_stream(name, params, f32_oracle, f32_mels, EPS_F32,
                                  bf16=False, **kw)
    by_path["engine f32"] = runs["engine f32"]["launches"]
    log(f"[engine] joins rewriting every slot (the reference's) against the "
        f"joiners' rows only: requests whose tokens differ, bf16 "
        f"{differ(runs['engine bf16'], runs['engine bf16 joiners-only rewrite'])}"
        f", f32 {differ(runs['engine f32'], runs['engine f32 joiners-only rewrite'])}"
        f" of {ENGINE_REQUESTS - 2}")

    plain = engine_numbers(runs["engine bf16"])

    # int4 weights (cli.serve --continuous --quant-bits 4)
    q4 = params_to(quantize_params(params, bits=4), dev)
    q4_oracle, q4_mels = engine_oracle(torch, dev, cfg, q4, tok, clips, True)
    q4_delta = step0_delta(torch, cfg, q4, list(q4_mels.values())[:EPS_WINDOWS],
                           prefix)
    run = serve_stream("engine int4", q4, q4_oracle, q4_mels, 2.0 * q4_delta)
    by_path["engine int4"] = run["launches"]
    n_enc, n_dec = cfg.n_audio_layer, cfg.n_text_layer
    # K7 where M * K <= 2M: 5 linears an encoder layer and the 2 cross
    # projections a decoder layer at batch 1; 8 a decoder layer a join and
    # a chunk step
    k7_want = (run["stats"]["joins"] * (5 * n_enc + 2 * n_dec)
               + 8 * n_dec * (run["join_events"] + run["stats"]["steps"]))
    require(run["launches"]["K7"] > 0, "engine int4: K7 launched")
    log(f"[engine int4] K7 {run['launches']['K7']} launches (predicted "
        f"{k7_want}); step-0 |bf16 - f32| {q4_delta:.4e}")
    del q4, run
    torch.cuda.empty_cache()

    phase_engine_http(torch, dev)
    log(f"[engine] phase passed in {time.time() - t_phase:.1f} s")
    return dict(clips=clips, gaps=gaps, oracle=oracle, mels=mels,
                eps=eps_bf16, plain=plain)


ENGINE_TREE_SLOTS = 32  # the tree's second run (ROADMAP item [11])
ENGINE_DRAFT_REQUESTS = 8  # the draft-model runs take the stream's first 8
# (the cancelled one among them, not the one with the deadline): their
# depth, cut for the script's wall


def expect_spec_launches(cfg, run, name: str, draft_cfg, draft_k: int) -> dict:
    """K1 once a joined window (the draft reuses the log-mel), K2 once an
    encoder layer of the target's, and of the draft model's, a join; K4
    once a draft decoder layer a draft step, K draft steps a round (the
    joins and the (K + 1)-query verifications take the plain int8
    cross-attention), none without a draft model."""
    joins, rounds = run["stats"]["joins"], run["stats"]["spec_rounds"]
    enc = cfg.n_audio_layer + (draft_cfg.n_audio_layer if draft_cfg else 0)
    want = {"K1": joins, "K2": enc * joins,
            "K4": draft_cfg.n_text_layer * draft_k * rounds if draft_cfg else 0}
    got = {k: run["launches"][k] for k in want}
    require(got == want and got["K1"] and got["K2"]
            and (got["K4"] or not draft_cfg),
            f"{name}: launches {got}, predicted {want}")
    return got


def phase_engine_speculative(torch, dev, cfg, params, tok, by_path,
                             stream) -> dict:
    """The in-flight engine's speculative modes at whisper-small's full width
    and depth, at the CLI's engine setting (bf16, int8 cross cache, 16
    slots, 64 tokens, 4 rounds a sync, prewarmed, K 4) on phase_engine's
    stream of 24 requests (one cancelled, one with a 0.2 s deadline): n-gram
    drafts, a self-draft (the acceptance ceiling) and a whisper-tiny draft
    from seed 1 (the floor), both on the stream's first
    ENGINE_DRAFT_REQUESTS requests, a Medusa chain and DEFAULT_TREE on
    fresh heads, and the tree again at 32 slots. Every window is held to
    decode() by the near-tie rule with phase_engine's bound, and K1/K2/K4
    launch as predicted from joins and rounds; first the test-tiny modes
    on the card against the CPU. Returns the draft-model runs' seconds."""
    import whisper_ipa_torch.serve_continuous as sc
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.medusa import init_medusa_params

    t_phase = time.time()
    phase_engine_parity(torch, dev, tok, modes=(
        ("n-gram", dict(draft_k=SPEC_K)),
        ("draft model", lambda c: dict(draft_k=SPEC_K, draft_cfg=c,
                                       draft_params=init_params(c, seed=7))),
        ("medusa chain", lambda c: dict(
            medusa_params=init_medusa_params(c, SPEC_K, seed=1))),
        ("medusa tree", lambda c: dict(
            medusa_params=init_medusa_params(c, SPEC_K, seed=1),
            medusa_tree=DEFAULT_TREE)),
    ))
    clips, gaps, oracle, mels, eps, plain = (stream[k] for k in (
        "clips", "gaps", "oracle", "mels", "eps", "plain"))
    tiny = CONFIGS["tiny"]
    draft = init_params(tiny, seed=1, device=dev)
    heads = init_medusa_params(cfg, SPEC_K, seed=0, device=dev)
    tree = dict(medusa_params=heads, medusa_tree=DEFAULT_TREE)
    log(f"[engine speculative] the plain engine on the same stream: "
        f"tokens/s {plain['tokens_per_s']}, TTFT p50 {plain['ttft_p50']} s, "
        f"wall {plain['wall_s']} s")
    draft_walls = {}
    for name, kw, draft_cfg, slots, n in (
        ("n-gram", dict(draft_k=SPEC_K), None, ENGINE_SLOTS, ENGINE_REQUESTS),
        ("self-draft", dict(draft_k=SPEC_K, draft_params=params,
                            draft_cfg=cfg), cfg, ENGINE_SLOTS,
         ENGINE_DRAFT_REQUESTS),
        ("whisper-tiny draft", dict(draft_k=SPEC_K, draft_params=draft,
                                    draft_cfg=tiny), tiny, ENGINE_SLOTS,
         ENGINE_DRAFT_REQUESTS),
        ("medusa chain", dict(medusa_params=heads), None, ENGINE_SLOTS,
         ENGINE_REQUESTS),
        ("medusa tree", tree, None, ENGINE_SLOTS, ENGINE_REQUESTS),
        (f"medusa tree {ENGINE_TREE_SLOTS} slots", tree, None,
         ENGINE_TREE_SLOTS, ENGINE_REQUESTS),
    ):
        name = f"engine {name}"
        deadline = ENGINE_DEADLINE if ENGINE_DEADLINE < n else None
        t0 = time.time()
        eng = sc.ContinuousBatcher(
            params, cfg, device=dev, slots=slots,
            max_new_tokens=ENGINE_MAX_NEW, bf16=True, kv_int8=True,
            tokenizer=tok, prewarm=True, **kw)
        prewarm_s = time.time() - t0
        try:
            run = run_engine(torch, dev, eng, clips[:n], gaps[:n],
                             cancel=ENGINE_CANCEL, deadline=deadline)
        finally:
            eng.close()
        require(not eng._thread.is_alive(), f"{name}: engine thread stopped")
        check_stream(run, name, deadline)
        expected = expect_spec_launches(cfg, run, name, draft_cfg, eng.draft_k)
        equal, near, at = check_engine_tokens(
            torch, cfg, params, tok, eng, run,
            {k: v for k, v in oracle.items() if k[0] < n}, mels, eps, name)
        st, numbers = run["stats"], engine_numbers(run)
        tpr = st["spec_emitted"] / max(st["spec_slot_rounds"], 1)
        against = (f"against the plain engine tokens/s "
                   f"{numbers['tokens_per_s'] / plain['tokens_per_s']:.3f}x, "
                   f"TTFT p50 {numbers['ttft_p50']} s against "
                   f"{plain['ttft_p50']} s" if n == ENGINE_REQUESTS else
                   f"the stream's first {n} requests")
        wall = time.time() - t0
        log(f"[{name}] {slots} slots, K {eng.draft_k}, {n} requests: tokens "
            f"a round {tpr:.4f} ({st['spec_emitted']} tokens over "
            f"{st['spec_slot_rounds']} active slot-rounds, {st['spec_rounds']} "
            f"rounds); {numbers}; {against}; prewarm {prewarm_s:.2f} s; "
            f"launches {nonzero(run['launches'])}, as predicted {expected}; "
            f"{equal} windows equal decode()'s, {near} leave it at a near-tie "
            f"(gaps {at}; eps {eps:.4e}); mode wall {wall:.1f} s")
        require(st["spec_rounds"] > 0 and st["spec_emitted"] > 0,
                f"{name}: the engine speculated")
        by_path[name] = run["launches"]
        if draft_cfg is not None:
            draft_walls[name] = round(wall, 1)
        del eng, run
    del draft, heads, tree
    torch.cuda.empty_cache()
    log(f"[engine speculative] phase passed in {time.time() - t_phase:.1f} s")
    return draft_walls


def phase_engine_http(torch, dev):
    """cli.serve --continuous --max-pending 2 on whisper-small over HTTP:
    /transcribe equals the engine called directly, /transcribe_stream one
    line a token then the final one, and a burst past --max-pending gets
    503s."""
    import io
    import threading
    import urllib.error

    from whisper_ipa_torch.audio import load_audio_bytes, write_wav
    from whisper_ipa_torch.cli import serve as serve_cli

    t0 = time.time()
    server, service = serve_cli.build_server([
        "--model", "small", "--device", str(dev), "--continuous",
        "--batch-size", "2", "--max-new-tokens", str(ENGINE_MAX_NEW),
        "--max-pending", "2", "--warmup", "--port", "0"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bodies = []
    for i, seconds in enumerate((8.0, 12.0)):
        buf = io.BytesIO()
        write_wav(buf, synthetic_audio(1, seconds, seed=90 + i)[0])
        bodies.append(buf.getvalue())
    codes = []
    try:
        build_s = time.time() - t0
        posted = _http(f"{url}/transcribe", bodies[0])[0]
        direct = service.transcribe(load_audio_bytes(bodies[0]), timeout=300)
        stream = _http(f"{url}/transcribe_stream", bodies[1])
        barrier = threading.Barrier(8)

        def burst():
            barrier.wait()
            try:
                _http(f"{url}/transcribe", bodies[0])
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        workers = [threading.Thread(target=burst) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        stats = _http(f"{url}/stats")[0]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    require(not thread.is_alive() and not service._thread.is_alive(),
            "server and engine threads stopped")
    kinds = [next(iter(line)) for line in stream]
    final = stream[-1]["final"]
    log(f"[engine serve] cli.serve --continuous, 2 slots, --max-pending 2, "
        f"built and prewarmed in {build_s:.1f} s: /transcribe {len(posted['tokens'])} "
        f"tokens, equal to the engine's direct answer "
        f"{posted['tokens'] == direct['tokens']}; /transcribe_stream "
        f"{kinds.count('partial')} partial lines then {kinds[-1]}; a burst of "
        f"8: codes {sorted(codes)}; stats {stats}")
    require(posted["tokens"] == direct["tokens"] and posted["tokens"],
            "/transcribe equals the engine's direct result")
    require(kinds == ["partial"] * (len(kinds) - 1) + ["final"]
            and [ln["partial"]["token"] for ln in stream[:-1]] == final["tokens"],
            "one partial line a token, then the final line")
    require(503 in codes and set(codes) <= {200, 503} and len(codes) == 8,
            "a burst past --max-pending gets 503")
    require(stats["rejected"] == codes.count(503), "/stats counts the 503s")


def grammar_ok(tokens, tb: int) -> bool:
    """Whisper's timestamp grammar on the host: the first token a timestamp
    within the initial 1 s, the timestamps never decreasing."""
    ts = [t for t in tokens if t >= tb]
    return bool(tokens) and tb <= tokens[0] <= tb + 50 and ts == sorted(ts)


def timed_decode(torch, dev, cfg, params, tok, audio, options):
    """waveform -> log-mel (K1) -> decode(); returns (wall s, launches,
    results), the launches counted from 0."""
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    reset_counts(torch)
    t0 = time.time()
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    results = decode(params, cfg, mel, options, tokenizer=tok)
    torch.cuda.synchronize()
    return time.time() - t0, read_counts(torch), results


def phase_timestamps(torch, dev, cfg, params, tok, by_path):
    """decode() on the default DecodingOptions (timestamp rules, language
    detection) in the serving setting, with the int8 and the int4 cross
    cache, and best-of-3 sampling."""
    from whisper_ipa_torch.decode import DecodingOptions

    tb = tok.timestamp_begin
    audio = torch.from_numpy(synthetic_audio(MAIN_BATCH, 30.0, seed=1)).to(dev)
    for name, cache, kernel in (("timestamps", dict(kv_int8=True), "K4"),
                                ("timestamps int4", dict(kv_int4=True), "K8")):
        options = DecodingOptions(fp16=True, sample_len=MAIN_SAMPLE_LEN, **cache)
        walls = []
        for _ in range(2):  # the first counted, both timed
            wall, launches, results = timed_decode(torch, dev, cfg, params,
                                                   tok, audio, options)
            walls.append(wall)
            if len(walls) == 1:
                by_path[name] = launches
        ok = [grammar_ok(r.tokens, tb) for r in results]
        lengths = [len(r.tokens) for r in results]
        log(f"[{name}] default DecodingOptions + fp16, {cache}, sample_len "
            f"{MAIN_SAMPLE_LEN}, batch {MAIN_BATCH} x 30 s: walls "
            f"{[round(w, 4) for w in walls]} s; tokens a row {lengths}; "
            f"languages {sorted(set(r.language for r in results))}; grammar "
            f"holds on every row {all(ok)}; launches {nonzero(by_path[name])}")
        require(len(results) == MAIN_BATCH and all(ok),
                f"{name}: every row obeys the timestamp grammar")
        require(by_path[name]["K1"] == 1 and
                by_path[name]["K2"] == cfg.n_audio_layer and
                by_path[name][kernel] > 0,
                f"{name}: K1 1, K2 {cfg.n_audio_layer}, {kernel} > 0")

    options = DecodingOptions(language="en", fp16=True, kv_int8=True,
                              sample_len=MAIN_SAMPLE_LEN, temperature=0.5,
                              best_of=3)
    wall, launches, results = timed_decode(torch, dev, cfg, params, tok,
                                           audio[:4], options)
    by_path["best-of 3"] = launches
    log(f"[best-of 3] temperature 0.5, batch 4 (12 candidates): wall "
        f"{wall:.4f} s; {len(results)} results, avg_logprob "
        f"{[round(r.avg_logprob, 3) for r in results]}; launches "
        f"{nonzero(launches)}")
    require(len(results) == 4 and all(np.isfinite(r.avg_logprob)
                                      and grammar_ok(r.tokens, tb)
                                      for r in results),
            "best-of 3: four finite results that obey the grammar")


BEAM_BATCH = 4
BEAM_SIZE = 5


def phase_beam(torch, dev, cfg, params, tok, by_path):
    """Beam search at batch 4 x beam 5, 64 tokens (EOT suppressed, so every
    run takes the same 63 beam steps), timestamps off and on, with the int8
    and the float cross cache. The beam loop's cross-attention has J = 5
    queries, so it takes the plain path, as the reference's einsum does:
    K4 runs in no beam run. The time a step is (wall at 64 tokens - wall
    at 1 token) / (the steps between them)."""
    import whisper_ipa_torch.decode.beam as beam
    from whisper_ipa_torch.decode import DecodingOptions

    audio = torch.from_numpy(synthetic_audio(BEAM_BATCH, 30.0, seed=3)).to(dev)
    real_step = beam.decode_step_beam
    steps = [0]

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return real_step(*args, **kwargs)

    beam.decode_step_beam = counted_step
    try:
        # warm-up: the beam loop's first shapes (sorts, gathers, einsums)
        timed_decode(torch, dev, cfg, params, tok, audio, DecodingOptions(
            language="en", beam_size=BEAM_SIZE, fp16=True, sample_len=2,
            kv_int8=True))
        for cache in ("int8", "float"):
            for ts in (False, True):
                name = f"beam {cache}" + (" timestamps" if ts else "")
                walls = {}
                for sample_len in (1, MAIN_SAMPLE_LEN):
                    options = DecodingOptions(
                        language="en", beam_size=BEAM_SIZE, fp16=True,
                        sample_len=sample_len, without_timestamps=not ts,
                        suppress_tokens=[-1, tok.eot],
                        kv_int8=cache == "int8")
                    steps[0] = 0
                    walls[sample_len], launches, results = timed_decode(
                        torch, dev, cfg, params, tok, audio, options)
                    walls[sample_len] = (walls[sample_len], steps[0])
                by_path[name] = launches
                (w1, s1), (w64, s64) = walls[1], walls[MAIN_SAMPLE_LEN]
                per_step = (w64 - w1) / (s64 - s1)
                ok = all(len(r.tokens) == MAIN_SAMPLE_LEN
                         and np.isfinite(r.avg_logprob) for r in results)
                grammar = all(grammar_ok(r.tokens, tok.timestamp_begin)
                              for r in results) if ts else None
                log(f"[{name}] whisper-small bf16, batch {BEAM_BATCH} x beam "
                    f"{BEAM_SIZE}, 64 tokens: wall {w64:.4f} s ({s64} beam "
                    f"steps; at 1 token {w1:.4f} s, {s1} step); "
                    f"{per_step * 1e3:.2f} ms a step; rows of 64 finite "
                    f"tokens {ok}; grammar {grammar}; launches "
                    f"{nonzero(launches)}")
                require(ok and grammar is not False,
                        f"{name}: 64 finite tokens a row")
                require(launches["K1"] == 1
                        and launches["K2"] == cfg.n_audio_layer
                        and launches["K4"] == 0 and launches["K8"] == 0,
                        f"{name}: K1 1, K2 {cfg.n_audio_layer}, no K4/K8 "
                        f"(S = J runs plain)")
    finally:
        beam.decode_step_beam = real_step


TRANSCRIBE_SECONDS = 75.0


def phase_transcribe(torch, dev, cfg, params, tok, by_path):
    """transcribe() on 75 s of seeded audio (3 windows), batched and
    sequential-timestamps, with phone timestamps, temperatures (0.0, 0.2).
    The decoder's token embeddings past the 256 byte tokens are zeroed,
    EOT's and the timestamps' excepted (as tests/test_torch_cli.py does for
    the text tokens): the random decoder then emits byte tokens between its
    timestamps, which this tokenizer decodes to text, so segments carry
    phones."""
    from whisper_ipa_torch.decode import transcribe

    audio = synthetic_audio(1, TRANSCRIBE_SECONDS, seed=4)[0]
    emb = params["decoder"]["token_embedding"].clone()
    emb[256:tok.eot] = 0.0
    emb[tok.eot + 1:tok.timestamp_begin] = 0.0
    params = {**params, "decoder": {**params["decoder"], "token_embedding": emb}}
    for mode in ("batched", "sequential"):
        reset_counts(torch)
        t0 = time.time()
        out = transcribe(params, cfg, audio, language="en",
                         temperature=(0.0, 0.2), word_timestamps=True,
                         sequential_timestamps=mode == "sequential",
                         tokenizer=tok, fp16=True, kv_int8=True,
                         sample_len=MAIN_SAMPLE_LEN)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = by_path[f"transcribe {mode}"] = read_counts(torch)
        segs = out["segments"]
        phones = [p for s in segs for p in s.get("phones", [])]
        bounds_ok = all(0.0 <= s["start"] <= s["end"] <= TRANSCRIBE_SECONDS
                        for s in segs) and all(
            a["start"] <= b["start"] for a, b in zip(segs, segs[1:]))
        phones_ok = all(
            0.0 <= p["start"] <= p["end"] <= TRANSCRIBE_SECONDS
            for p in phones) and all(
            all(a["start"] <= b["start"] for a, b in zip(s["phones"],
                                                          s["phones"][1:]))
            for s in segs if "phones" in s)
        log(f"[transcribe {mode}] whisper-small bf16 int8 cross-KV, "
            f"{TRANSCRIBE_SECONDS:.0f} s of audio, temperatures (0.0, 0.2), "
            f"64 tokens a window: wall {wall:.4f} s; {len(segs)} segments "
            f"(temperatures {[s['temperature'] for s in segs]}), "
            f"{len(phones)} phones; bounds within the audio and monotone "
            f"{bounds_ok}, phones {phones_ok}; launches {nonzero(launches)}")
        require(bounds_ok and phones_ok, f"transcribe {mode}: bounds")
        require(launches["K1"] > 0 and launches["K2"] > 0
                and launches["K4"] > 0, f"transcribe {mode}: K1, K2, K4 ran")
        if mode == "batched":
            require(out["text"] and len(segs) <= 3 and phones,
                    "batched: text, at most one segment a window, phones")


TRAIN_IPAS = ["kæt", "bʌtn̩", "ə̥tʃ", "aːm", "ɡɯɣ", "n̩æp", "t͡ʃiːz", "ŋ̊ʷa",
              "ðɪs ɪz", "wɔːtɚ", "ʃɪp", "θɹiː"]


def write_train_set(root: str, n: int, seed: int) -> str:
    """A seeded synthetic set in the pipeline's JSON schema: each WAV is the
    formant synthesizer's rendering (data.synth.synthesize_ipa, synthesis
    seed ``seed`` + i) of an IPA string from a fixed list."""
    from whisper_ipa_torch.audio import write_wav
    from whisper_ipa_torch.data.synth import synthesize_ipa

    os.makedirs(root, exist_ok=True)
    entries = []
    for i in range(n):
        ipa = TRAIN_IPAS[i % len(TRAIN_IPAS)]
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=seed + i))
        entries.append({"audio_path": path, "ipa_transcription": ipa,
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
              save_every: int, resume: bool = False, steps_per_call: int = 1):
    """train() at whisper-small, bf16 activations; returns (per-step
    (loss, step time s) from the log, launches, peak GB, wall s)."""
    from whisper_ipa_torch.train import train

    reset_counts(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    train(model_name="small", train_data_path=data, test_data_path=data,
          output_dir=out, num_steps=steps, batch_size=TRAIN_BATCH,
          learning_rate=TRAIN_LR, validate_every=0, save_every=save_every,
          resume=resume, mel_cache_dir=os.path.join(os.path.dirname(data),
                                                    "mels"),
          compute_dtype="bfloat16", freeze_encoder=freeze,
          final_validate=False, steps_per_call=steps_per_call, device="cuda")
    launches = read_counts(torch)
    wall = time.time() - t0
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
        reset_counts(torch)
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
        launches = by_path["HTTP service merged"] = read_counts(torch)
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


def phase_decoding_entry_points(torch, dev, cfg, data: str, run_dir: str,
                                by_path):
    """The entry points this slice opened, on the decoder-only checkpoint:
    cli.evaluate_model --beam-size 5, cli.transcribe --bf16 --json on three
    of the set's WAVs, and one HTTP request to cli.serve --beam-size 2."""
    import contextlib
    import io
    import threading

    from whisper_ipa_torch.audio import N_SAMPLES, load_audio, pad_or_trim
    from whisper_ipa_torch.cli import evaluate_model
    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.cli import transcribe as transcribe_cli
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    t_phase = time.time()
    ckpt = os.path.join(run_dir, f"checkpoint-{TRAIN_STEPS}")
    with open(data) as f:
        wavs = [e["audio_path"] for e in json.load(f)]

    reset_counts(torch)
    t0 = time.time()
    results = evaluate_model.main([
        "--skip-base", "--base-model", "small", "--checkpoint", ckpt,
        "--test-data", data, "--num-samples", "0", "--beam-size", "5"])
    by_path["entry evaluate_model beam 5"] = read_counts(torch)
    log(f"[entry evaluate_model --beam-size 5] {len(results['hypotheses'])} "
        f"samples, f32, batch 8, in {time.time() - t0:.1f} s: PER "
        f"{results['per']:.2f}%, PFER {results['pfer']:.2f}%; launches "
        f"{nonzero(by_path['entry evaluate_model beam 5'])}")
    require(len(results["hypotheses"]) == TRAIN_BATCH
            and np.isfinite(results["per"]) and np.isfinite(results["pfer"]),
            "beam evaluation scored every sample")

    reset_counts(torch)
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        transcribe_cli.main(["--model", "small", "--checkpoint", ckpt,
                             "--bf16", "--json", *wavs[:3]])
    launches = by_path["entry transcribe"] = read_counts(torch)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    seconds = [len(load_audio(w)) / SAMPLE_RATE for w in wavs[:3]]
    ok = [ln["file"] == w and all(0.0 <= s["start"] <= s["end"] <= sec
                                  for s in ln["segments"])
          for ln, w, sec in zip(lines, wavs, seconds)]
    log(f"[entry transcribe --bf16 --json] {len(lines)} files in "
        f"{time.time() - t0:.1f} s: texts {[ln['text'] for ln in lines]}; "
        f"segments within their audio {ok}; launches {nonzero(launches)}")
    require(len(lines) == 3 and all(ok), "cli.transcribe: one JSON line a file")
    require(launches["K1"] == 3 and launches["K2"] == 3 * cfg.n_audio_layer,
            "cli.transcribe: K1 and K2 once a window")

    server, service = serve_cli.build_server([
        "--model", "small", "--checkpoint", ckpt, "--batch-size", "4",
        "--port", "0", "--beam-size", "2"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    reset_counts(torch)
    thread.start()
    try:
        t0 = time.time()
        got = _http(f"{url}/transcribe", json.dumps({"path": wavs[4]}).encode(),
                    "application/json")[0]
        wall = time.time() - t0
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    launches = by_path["HTTP service beam 2"] = read_counts(torch)
    require(not thread.is_alive() and not service._thread.is_alive(),
            "server and service threads stopped")
    group = [pad_or_trim(load_audio(wavs[4]))] + [np.zeros(N_SAMPLES,
                                                           np.float32)] * 3
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(np.stack(group)).to(dev),
                                  n_mels=cfg.n_mels)
    want = decode(service.params, cfg, mel, service.options,
                  tokenizer=service.tokenizer)[0].text
    log(f"[entry serve --beam-size 2] one /transcribe in {wall:.3f} s: "
        f"{got['text']!r}, equal to decode()'s {got['text'] == want}; "
        f"launches {nonzero(launches)}")
    require(got["text"] == want, "the beam server's text equals decode()'s")
    require(launches["K1"] == 1 and launches["K2"] == cfg.n_audio_layer
            and launches["K4"] == 0, "beam server: K1 1, K2 12, no K4")
    log(f"[entry points, decoding] phase passed in {time.time() - t_phase:.1f} s")


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
    # the mel cache filled first (K1), so that every run reads the same
    # float16 mels: a run that fills it trains its first step on the
    # unrounded ones
    create_data_loader(data, n_mels=cfg.n_mels, mel_cache_dir=os.path.join(
        os.path.dirname(data), "mels")).precompute_mels(dev)
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
            phase_decoding_entry_points(torch, dev, cfg, data, out, by_path)
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
        if freeze:
            sequential = final

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
    t0 = time.time()
    results["decoder-only chunked"] = phase_train_chunked(
        torch, dev, data, root, results["decoder-only"], sequential)
    del sequential
    phase_train_sync_free(torch, dev, data)
    results["decoder-only chunked"]["added_s"] = time.time() - t0
    return results


def phase_train_chunked(torch, dev, data: str, root: str, seq: dict,
                        sequential) -> dict:
    """The decoder-only run again with steps_per_call=4 (chunks of 4, 4 and
    2) on the same data and seed: every logged loss and the final
    checkpoint's decoder equal the one-step-a-call run's (every step sees
    the same batch, so bit for bit is expected; else within 1e-6 relative,
    the gap printed), K2 12 a step and no K5."""
    out = os.path.join(root, "decoder-only-chunked")
    log_rows, launches, peak_gb, wall = run_train(
        torch, dev, data, out, True, TRAIN_STEPS, save_every=0,
        steps_per_call=4)
    final = checkpoint_params(os.path.join(out, f"checkpoint-{TRAIN_STEPS}"))
    shutil.rmtree(out)
    steps = sorted(log_rows)
    require(steps == sorted(seq["log"]),
            f"chunked: the logged steps {steps} are the sequential run's")
    gaps = [abs(log_rows[s][0] - seq["log"][s][0]) / abs(seq["log"][s][0])
            for s in steps]
    dec = [n for n in final if n.startswith("decoder.")]
    diff = max(float((final[n] - sequential[n]).abs().max()) for n in dec)
    bitwise = max(gaps) == 0 and diff == 0
    chunk_s = [log_rows[s][1] for s in steps]
    log(f"[train decoder-only chunked] steps_per_call 4 ({TRAIN_STEPS} steps: "
        f"chunks 4, 4, 2): losses at steps {steps} "
        f"{[round(log_rows[s][0], 6) for s in steps]}; "
        + ("bit for bit equal to the one-step-a-call run's, losses and the "
           "decoder's checkpoint" if bitwise else
           f"largest relative loss gap {max(gaps):.3e}, largest decoder "
           f"difference {diff:.3e} (bound 1e-6 relative)")
        + f"; step time (chunk wall / its steps) {[round(x, 4) for x in chunk_s]}"
        f" s against the one-step-a-call run's median "
        f"{seq['steady_step_s']:.4f} s; peak {peak_gb:.2f} GB; wall "
        f"{wall:.1f} s; launches {nonzero(launches)}")
    require(max(gaps) <= 1e-6, "chunked: losses within 1e-6 of sequential")
    require(all(float((final[n] - sequential[n]).abs().max())
                <= 1e-6 * float(sequential[n].abs().max()) for n in dec),
            "chunked: each decoder tensor within 1e-6 of its largest value")
    require(launches["K2"] == 12 * TRAIN_STEPS,
            f"chunked: K2 launched 12 x steps, got {launches['K2']}")
    require(launches["K5"] == 0, "chunked: no K5 launch")
    return dict(launches=launches, log=log_rows, peak_gb=peak_gb,
                steady_step_s=float(np.median(chunk_s)), bitwise=bitwise)


def count_syncs(torch, fn) -> dict:
    """{"file:line": count} of the host syncs in one fn() call: the warnings
    of sync-debug mode "warn", one a synchronizing CUDA call, each at the
    Python line that made it."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                        for w in seen
                        if "called a synchronizing" in str(w.message)))


def host_copy_adamw(torch):
    """The optimizer (constant rate, clipped) with its scalars copied from
    the host as the port made them before its step became sync-free (a
    ``torch.tensor`` on the device for b1 and b2, and for b1 again in each
    tensor's update), with the same arithmetic: what the sync count is
    compared with."""
    from whisper_ipa_torch.train.optimizer import B1, B2, EPS, Optimizer

    class HostCopyAdamW(Optimizer):
        def _adamw(self, flat_params, grads, state, reduce_sq=None):
            count = state.count + 1
            device = next(iter(grads.values())).device
            f32 = dict(dtype=torch.float32, device=device)
            bc1 = 1 - torch.tensor(B1, **f32) ** count
            bc2 = 1 - torch.tensor(B2, **f32) ** count
            lr = self.learning_rate
            sq = {name: (g * g).sum() for name, g in grads.items()}
            for name, g in grads.items():
                p = flat_params[name]
                g = g * torch.clamp_max(
                    self.max_grad_norm / (torch.sqrt(sq[name]) + 1e-6), 1.0)
                m = state.mu[name]
                mu = (1 - B1) * g + torch.tensor(B1, dtype=m.dtype,
                                                 device=m.device) * m
                nu = (1 - B2) * (g * g) + B2 * state.nu[name]
                u = (mu / bc1.to(mu.dtype)) / (
                    torch.sqrt(nu / bc2.to(nu.dtype)) + EPS)
                p.add_(-lr * (u + self.weight_decay * p))
                state.mu[name] = mu.to(m.dtype)
                state.nu[name] = nu
            state.count = count

    return HostCopyAdamW


def phase_train_sync_free(torch, dev, data: str) -> None:
    """The step body waits for the card nowhere: one train_step and one
    train_chunk of 4 steps (whisper-small, decoder-only, bf16, batch 12)
    run under torch.cuda.set_sync_debug_mode("error"), which raises at a
    synchronizing call. Then, for information, the host syncs of one step
    counted under "warn" with the optimizer's scalars made by fill kernels
    against copied from the host."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.train import create_train_state, train_chunk, train_step

    cfg = CONFIGS["small"]
    dataset = create_data_loader(data, n_mels=cfg.n_mels,
                                 mel_cache_dir=os.path.join(
                                     os.path.dirname(data), "mels"))
    batch = dataset.get_batch(list(range(TRAIN_BATCH)))
    mel = torch.from_numpy(batch["mel_features"]).to(dev, torch.bfloat16)
    tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
    mels, toks = mel.expand(4, *mel.shape), tokens.expand(4, *tokens.shape)
    eot = dataset.tokenizer.eot
    state, tx = create_train_state(init_params(cfg, seed=0, device=dev),
                                   learning_rate=TRAIN_LR)
    kw = dict(freeze_encoder=True, dtype_name="bfloat16")

    def step(opt=tx):
        train_step(state, mel, tokens, cfg, opt, eot, **kw)

    def chunk():
        train_chunk(state, mels, toks, cfg, tx, eot, **kw)

    step()  # warm-up: the kernels' libraries, cuBLAS, the allocator
    torch.cuda.synchronize()
    after = count_syncs(torch, step)
    for name, fn in (("train_step", step), ("train_chunk of 4", chunk)):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            raise AssertionError(f"{name} synchronized the host: {e}; under "
                                 f"\"warn\" a step synced at {after}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    n_tensors = len(state.opt_state.mu)
    host_tx = host_copy_adamw(torch)(learning_rate=TRAIN_LR)
    before = count_syncs(torch, lambda: step(host_tx))
    log(f"[train sync-free] whisper-small decoder-only bf16 batch {TRAIN_BATCH}:"
        f" train_step and a train_chunk of 4 ran under sync-debug \"error\" "
        f"without a synchronizing call; host syncs in one step (sync-debug "
        f"\"warn\", {n_tensors} trainable tensors): "
        f"{sum(after.values())} with the scalars made by fill kernels "
        f"({after}), {sum(before.values())} with them copied from the host ("
        + ", ".join(f"{n} at {site}" for site, n in before.items()) + ")")


class ArmWindows:
    """Replaces a switch of ``models.layers`` (``use_decode_kernel``,
    ``use_int4_matmul``) while an A/B CLI runs: each call of the switch
    closes the running window and opens the next, so each arm's launches
    (the wrappers' counts) and device kernels (under torch.profiler, by
    name: ``cli.profile_serving.port_kernel_times``) are read apart. With
    ``first_call`` (a module and a function name in it) the profiler
    covers only the first call of that function in each window (one
    decode of an arm, not its repeats: the profiler's cost is per kernel
    event); ``profiled`` (indices of the switch's calls) limits it to those
    windows."""

    def __init__(self, torch, layers, name: str, first_call=None,
                 profiled=None):
        self.torch, self.layers, self.name = torch, layers, name
        self.switch = getattr(layers, name)
        self.first_call, self.profiled = first_call, profiled
        self.windows, self.prof, self.flag, self.events = [], None, None, None
        self.open, self.calls, self.profiling = False, 0, False

    def __enter__(self):
        setattr(self.layers, self.name, self)
        if self.first_call is not None:
            module, attr = self.first_call
            self.wrapped = getattr(module, attr)
            setattr(module, attr, self._first)
        return self

    def _start(self):
        self.prof = self.torch.profiler.profile(
            activities=[self.torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def _stop(self):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.events = [e for e in self.prof.key_averages()
                       if e.device_type == self.torch.autograd.DeviceType.CUDA]
        self.prof = None

    def _first(self, *args, **kwargs):
        if (not self.open or not self.profiling or self.events is not None
                or self.prof is not None):
            return self.wrapped(*args, **kwargs)
        self._start()
        try:
            return self.wrapped(*args, **kwargs)
        finally:
            self._stop()

    def __call__(self, flag):
        self.close()
        self.flag, self.t0, self.events, self.open = flag, time.time(), None, True
        self.profiling = self.profiled is None or self.calls in self.profiled
        self.calls += 1
        reset_counts(self.torch)
        if self.first_call is None and self.profiling:
            self._start()
        self.switch(flag)

    def close(self):
        if not self.open:
            return
        from whisper_ipa_torch.cli.profile_serving import port_kernel_times

        counts = read_counts(self.torch)
        if self.prof is not None:
            self._stop()
        self.windows.append(dict(flag=self.flag, launches=nonzero(counts),
                                 device=port_kernel_times(self.events or []),
                                 profiled=self.events is not None,
                                 s=time.time() - self.t0))
        self.open = False

    def __exit__(self, *exc):
        self.close()
        setattr(self.layers, self.name, self.switch)
        if self.first_call is not None:
            setattr(*self.first_call, self.wrapped)


def phase_kernel_ab(torch, dev) -> float:
    """The two kernel A/B CLIs, short: cli.bench_decode_kernel at batch 16,
    8 steps, one repeat, on the int8 cache (plain against K4) and the int4
    cache (against K8); cli.bench_quant_decode at whisper-small, batch 16,
    16 tokens, one repeat, in its four modes. Each arm's launches and
    device kernels are read apart (ArmWindows): K4 / K8 run in the kernel
    arm and not in the plain one (each arm under the profiler); K7 in
    int4-kernel (its first decode under the profiler, and counted) and
    not in int4, f32 or int8 (counted). Returns the phase's wall."""
    import whisper_ipa_torch.decode as decoding
    from whisper_ipa_torch.cli import bench_decode_kernel, bench_quant_decode
    from whisper_ipa_torch.models import layers

    t_phase = time.time()
    for int4 in (False, True):
        k = "K8" if int4 else "K4"
        t0 = time.time()
        with ArmWindows(torch, layers, "use_decode_kernel") as arms:
            res = bench_decode_kernel.main(
                ["--batch", "16", "--steps", "8", "--repeats", "1"]
                + (["--int4"] if int4 else []))
        plain, kernel = arms.windows[0], arms.windows[1]
        log(f"[kernel A/B decode {'int4' if int4 else 'int8'}] "
            f"cli.bench_decode_kernel B 16, 8 steps x 12 layers "
            f"({time.time() - t0:.1f} s): ms a token "
            f"{res}; plain arm launches {plain['launches']}, device "
            f"{plain['device']}; {k} arm launches {kernel['launches']}, "
            f"device {kernel['device']}")
        require(plain["flag"] is False and kernel["flag"] is True,
                "the CLI's arms: plain, then the kernel")
        require(plain["launches"].get(k, 0) == 0 and k not in plain["device"],
                f"no {k} in the plain arm")
        require(kernel["launches"].get(k) == 2 * 8 * 12 and k in kernel["device"],
                f"{k} launched 2 runs x 8 steps x 12 layers in its arm")
    t0 = time.time()
    # each mode sets the switch and resets it to True after: the modes'
    # windows are the even calls, int4-kernel's the seventh. K7's only launcher is
    # its counted wrapper (ops/quant_matmul.int4_matmul), so the counts
    # show it absent from the other modes; K4 and K8 have an uncounted
    # launcher too (launch_cluster), so both their arms are profiled
    with ArmWindows(torch, layers, "use_int4_matmul",
                    first_call=(decoding, "decode"), profiled={6}) as arms:
        res = bench_quant_decode.main(["--sample-len", "16", "--repeats", "1"])
    modes = arms.windows[0::2]
    by_mode = dict(zip(res, modes))
    log(f"[kernel A/B quantized decode] cli.bench_quant_decode whisper-small "
        f"batch 16, 16 tokens ({time.time() - t0:.1f} s; windows "
        f"{[round(w['s'], 1) for w in arms.windows]} s): s a decode {res}; "
        f"launches by mode "
        + "; ".join(f"{m}: {w['launches']}, device K7 "
                    f"{w['device'].get('K7')}" for m, w in by_mode.items()))
    require(list(by_mode) == ["f32", "int8", "int4", "int4-kernel"],
            f"the four modes ran, each in its window: {list(by_mode)}")
    for m, w in by_mode.items():
        kernel = m == "int4-kernel"
        require(w["flag"] is kernel, f"{m}: use_int4_matmul({kernel})")
        require((w["launches"].get("K7", 0) > 0) == kernel,
                f"K7 launched in {m}: {kernel}")
        if kernel:
            require(w["profiled"] and "K7" in w["device"],
                    "K7 on the device in int4-kernel's first decode")
    wall = time.time() - t_phase
    log(f"[kernel A/B] phase passed in {wall:.1f} s")
    return wall


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


# -- the learning path: a synthetic corpus, whisper-tiny from random init ---

LEARN_TRAIN = 256
LEARN_HELDOUT = 48
LEARN_STEPS = 600
LEARN_BATCH = 16
LEARN_LR = 2e-4
LEARN_WARMUP = 50
LEARN_VALIDATE_EVERY = 200
LEARN_ORACLE = 8  # held-out utterances of the phone-timestamp oracle
LEARN_GAP = 0.5  # seconds of silence between utterances of the long input
LEARN_LONG = (45.0, 60.0)  # seconds of the long input


class tee_stdout:
    """Copy what is printed inside the block into ``path`` as well (the
    console output a training run's monitor reads)."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.file = open(self.path, "w", encoding="utf-8")
        self.stdout = sys.stdout
        sys.stdout = self
        return self

    def write(self, text):
        self.file.write(text)
        return self.stdout.write(text)

    def flush(self):
        self.file.flush()
        self.stdout.flush()

    def __exit__(self, *exc):
        sys.stdout = self.stdout
        self.file.close()


def read_val_log(out: str) -> list:
    import csv

    with open(os.path.join(out, "validation_log.csv"), newline="") as f:
        return [(int(r[0]), float(r[1]), float(r[2]))
                for r in csv.reader(f) if r and r[0].isdigit()]


def device_decode_scores(params, cfg, tok, entries, options,
                         cond: str = "clean", batch: int = 16) -> dict:
    """Held-out scores through examples/torch_perturbed_eval.decode_split:
    each waveform (perturbed by ``cond``) -> log-mel on the card (K1),
    batches padded to ``batch`` with their last row -> decode()."""
    from whisper_ipa_torch.metrics import evaluate_batch

    refs, hyps = example("torch_perturbed_eval").decode_split(
        params, cfg, tok, entries, options, batch, cond)
    return {**evaluate_batch(refs, hyps), "references": refs,
            "hypotheses": hyps}


def phase_learn(torch, dev, root: str, by_path) -> dict:
    """examples/generalization.py's recipe through the port on the card:
    256 synthetic utterances, whisper-tiny (full width) from random init
    trained 600 steps (encoder unfrozen, bf16 activations, f32 AdamW), and
    the checkpoint scored on 48 held-out utterances whose phone sequences
    and synthesis seeds it never saw; then the evaluation, error-analysis,
    phone-timestamp, long-form and perturbed-audio paths on it."""
    from whisper_ipa_torch.audio import load_audio, pad_or_trim
    from whisper_ipa_torch.cli import error_analysis, evaluate_model
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.data.synth import synthesize_phonemes_with_alignment
    from whisper_ipa_torch.decode import (DecodingOptions, phone_timestamps,
                                          transcribe)
    from whisper_ipa_torch.metrics import per as per_module
    from whisper_ipa_torch.metrics import phone_error_rate
    from whisper_ipa_torch.metrics.analysis import align_phones
    from whisper_ipa_torch.metrics.segment import (
        normalize_ipa_for_comparison, tokenize_ipa)
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.models.convert import unflatten_params
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.train import train, validate

    t_phase = time.time()
    cfg = CONFIGS["tiny"]
    t0 = time.time()
    generalization = example("torch_generalization")
    train_json, heldout_json = generalization.make_dataset(
        os.path.join(root, "data"), LEARN_TRAIN, LEARN_HELDOUT)
    with open(heldout_json) as f:
        heldout = json.load(f)
    log(f"[learn data] {LEARN_TRAIN} train + {LEARN_HELDOUT} held-out "
        f"utterances synthesized in {time.time() - t0:.1f} s; PER through the "
        f"native edit-distance core {per_module._native_levenshtein is not None}")

    # the mel cache both train() and the scoring below read, filled on the
    # card (K1) inside the training count
    cache = os.path.join(root, "melcache")
    out = os.path.join(root, "run")
    reset_counts(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    n_mels = [create_data_loader(p, n_mels=cfg.n_mels, mel_cache_dir=cache)
              .precompute_mels(dev) for p in (train_json, heldout_json)]
    mel_batches = sum(-(-n // 16) for n in n_mels)  # precompute_mels' batch
    mel_s = time.time() - t0
    console = os.path.join(root, "learn_console.log")  # calculate_real_speed's
    with tee_stdout(console):
        summary = train(model_name="tiny", train_data_path=train_json,
                        test_data_path=heldout_json, output_dir=out,
                        num_steps=LEARN_STEPS, batch_size=LEARN_BATCH,
                        learning_rate=LEARN_LR,
                        validate_every=LEARN_VALIDATE_EVERY, save_every=0,
                        freeze_encoder=False, warmup_steps=LEARN_WARMUP,
                        compute_dtype="bfloat16", final_validate=True,
                        final_validate_samples=LEARN_HELDOUT,
                        mel_cache_dir=cache, device=str(dev))
    launches = by_path["learn train"] = read_counts(torch)
    train_wall = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rows = read_train_log(out)
    steps = sorted(rows)
    losses = [rows[s][0] for s in steps]
    step_s = [rows[s][1] for s in steps if s > 5]
    val = read_val_log(out)
    log(f"[learn train] whisper-tiny from random init, encoder unfrozen, bf16 "
        f"activations, f32 AdamW, batch {LEARN_BATCH}, lr {LEARN_LR:g}, "
        f"{LEARN_WARMUP} warmup steps, {LEARN_STEPS} steps: mel cache of "
        f"{sum(n_mels)} utterances on the card (K1, {mel_batches} launches) "
        f"in {mel_s:.1f} s; losses "
        f"{[(s, round(x, 4)) for s, x in zip(steps, losses)]}; step time (host "
        f"clock, synchronised, logged steps after 5) median "
        f"{float(np.median(step_s)):.4f} s, range {min(step_s):.4f}-"
        f"{max(step_s):.4f} s; peak device memory {peak_gb:.2f} GB; wall "
        f"{train_wall:.1f} s (validation included); held-out (step, PER, "
        f"PFER) {val}; launches {nonzero(launches)}")
    require(all(np.isfinite(losses)), "learn: finite losses")
    require(losses[-1] < 0.1 * losses[0], "learn: the last loss is under a "
            "tenth of the first")
    require(launches["K1"] == mel_batches > 0,
            "learn: K1 filled the mel cache, once a batch of 16")
    require(launches["K5"] == cfg.n_audio_layer * LEARN_STEPS,
            f"learn: K5 launched 4 x {LEARN_STEPS}, got {launches['K5']}")
    require(launches["K2"] >= cfg.n_audio_layer * LEARN_STEPS,
            f"learn: K2 launched at least 4 x {LEARN_STEPS}")
    require([s for s, _, _ in val][:3] == [LEARN_VALIDATE_EVERY * k
                                           for k in (1, 2, 3)],
            "learn: held-out scores at steps 200, 400 and 600")

    ckpt = os.path.join(out, f"checkpoint-{LEARN_STEPS}")
    params = params_to(unflatten_params(checkpoint_params(ckpt)), dev)
    heldout_ds = create_data_loader(heldout_json, n_mels=cfg.n_mels,
                                    mel_cache_dir=cache)
    tok = heldout_ds.tokenizer
    reset_counts(torch)
    t0 = time.time()
    floor = validate(init_params(cfg, seed=1, device=dev), cfg, heldout_ds,
                     tok, num_samples=16)
    train_score = validate(params, cfg, create_data_loader(
        train_json, n_mels=cfg.n_mels, mel_cache_dir=cache), tok,
        num_samples=48)
    by_path["learn floor and train score"] = read_counts(torch)
    heldout_pfer = summary["final_pfer"]
    log(f"[learn scores] random-model floor (init seed 1, 16 held-out): PER "
        f"{floor['per']:.2f}%, PFER {floor['pfer']:.2f}%; train set (48): PER "
        f"{train_score['per']:.2f}%, PFER {train_score['pfer']:.2f}%; held-out "
        f"(48, final): PER {summary['final_per']:.2f}%, PFER "
        f"{heldout_pfer:.2f}%; in {time.time() - t0:.1f} s")
    require(train_score["per"] <= 20.0, "learn: train PER <= 20%")
    require(heldout_pfer <= 60.0, "learn: held-out PFER <= 60%")
    require(heldout_pfer <= floor["pfer"] - 30.0,
            "learn: held-out PFER at least 30 points under the floor's")

    # the evaluation CLI on the checkpoint: greedy and beam 5 (the float
    # cache, as the CLI decodes), then greedy with the int8 cache (K4)
    evals = {}
    for name, extra in (("greedy", []), ("beam 5", ["--beam-size", "5"])):
        reset_counts(torch)
        t0 = time.time()
        r = evaluate_model.main([
            "--skip-base", "--base-model", "tiny", "--checkpoint", ckpt,
            "--test-data", heldout_json, "--num-samples", "0", "--device",
            dev.type, *extra])
        evals[name] = dict(r, wall=time.time() - t0,
                           launches=read_counts(torch))
        by_path[f"learn evaluate_model {name}"] = evals[name]["launches"]
    reset_counts(torch)
    t0 = time.time()
    evals["greedy int8"] = dict(device_decode_scores(
        params, cfg, tok, heldout,
        DecodingOptions(language="en", without_timestamps=True,
                        kv_int8=True)), wall=None)
    evals["greedy int8"]["wall"] = time.time() - t0
    evals["greedy int8"]["launches"] = by_path["learn decode int8"] = \
        read_counts(torch)
    log("[learn evaluate] 48 held-out utterances, f32: " + "; ".join(
        f"{k} PER {v['per']:.2f}% PFER {v['pfer']:.2f}% wall {v['wall']:.2f} s"
        f" launches {nonzero(v['launches'])}" for k, v in evals.items()))
    require(all(np.isfinite([v["per"], v["pfer"]]).all()
                and len(v["hypotheses"]) == LEARN_HELDOUT
                for v in evals.values()), "learn: every evaluation scored")
    require(evals["greedy int8"]["launches"]["K4"] > 0,
            "learn: K4 ran the int8-cache evaluation")

    # cli.error_analysis on the same checkpoint; its totals against the
    # alignment of the greedy evaluation's pairs (the same decode)
    report_path = os.path.join(root, "error_analysis.json")
    reset_counts(torch)
    report = error_analysis.main([
        "--checkpoint", ckpt, "--test-data", heldout_json, "--base-model",
        "tiny", "--output", report_path, "--device", dev.type])
    by_path["learn error_analysis"] = read_counts(torch)
    pairs = list(zip(evals["greedy"]["references"],
                     evals["greedy"]["hypotheses"]))
    ops = [align_phones(tokenize_ipa(normalize_ipa_for_comparison(r)),
                        tokenize_ipa(normalize_ipa_for_comparison(h)))
           for r, h in pairs]
    n_ref = sum(len(tokenize_ipa(normalize_ipa_for_comparison(r)))
                for r, _ in pairs)
    n_match = sum(op == "match" for o in ops for op, _, _ in o)
    subs = {}
    for o in ops:
        for op, r, h in o:
            if op == "sub":
                subs[(r, h)] = subs.get((r, h), 0) + 1
    top = [(tuple(k), c) for k, c in report["top_substitutions"][:5]]
    log(f"[learn error_analysis] {report['num_pairs']} pairs, phone accuracy "
        f"{report['phone_accuracy'] * 100:.2f}%; top substitutions "
        f"{top}; deletions {report['top_deletions'][:3]}; insertions "
        f"{report['top_insertions'][:3]}")
    with open(report_path) as f:
        written = json.load(f)
    require(report["num_pairs"] == LEARN_HELDOUT
            and written["num_pairs"] == LEARN_HELDOUT,
            "error_analysis: every pair, and the report written")
    require(abs(report["phone_accuracy"] - n_match / n_ref) < 1e-12
            and all(subs.get(k) == c for k, c in top)
            and report["per_scores"] == [phone_error_rate(
                normalize_ipa_for_comparison(r),
                normalize_ipa_for_comparison(h)) for r, h in pairs],
            "error_analysis: its totals agree with the alignment of the "
            "greedy evaluation's pairs")

    # the phone-timestamp oracle: held-out utterances again, with the
    # synthesizer's true phone boundaries
    items = generalization.sequences(LEARN_TRAIN, LEARN_HELDOUT)["heldout"]
    reset_counts(torch)
    errors, oracle_ok = [], True
    for seq, seed in items[:LEARN_ORACLE]:
        audio, align = synthesize_phonemes_with_alignment(list(seq), seed=seed)
        seconds = align[-1][2]
        with torch.inference_mode():
            mel = log_mel_spectrogram(
                torch.from_numpy(pad_or_trim(audio)).to(dev)[None],
                n_mels=cfg.n_mels)
        ts = phone_timestamps(params, cfg, tok.encode("".join(seq)), mel,
                              tokenizer=tok, audio_seconds=seconds)
        oracle_ok &= [d["phone"] for d in ts] == [a[0] for a in align]
        oracle_ok &= all(0.0 <= d["start"] <= d["end"] <= seconds for d in ts)
        oracle_ok &= all(a["start"] <= b["start"] for a, b in zip(ts, ts[1:]))
        for (_, start, end), d in zip(align, ts):
            errors += [abs(d["start"] - start), abs(d["end"] - end)]
    by_path["learn phone timestamps"] = read_counts(torch)
    errors = np.array(errors) * 1e3
    log(f"[learn phone timestamps] {LEARN_ORACLE} held-out utterances, "
        f"reference tokens against the synthesizer's boundaries: mean error "
        f"{errors.mean():.1f} ms, p90 {np.percentile(errors, 90):.1f} ms, max "
        f"{errors.max():.1f} ms over {len(errors)} boundaries; phone lists "
        f"equal, bounds monotone within the audio {oracle_ok}")
    require(oracle_ok, "learn: phone lists match, bounds monotone within "
            "the audio")

    # long-form: held-out utterances joined with LEARN_GAP s of silence
    gap = np.zeros(int(LEARN_GAP * SAMPLE_RATE), np.float32)
    pieces, refs = [], []
    for e in heldout:
        audio = load_audio(e["audio_path"])
        if (sum(map(len, pieces)) + len(audio)) / SAMPLE_RATE > LEARN_LONG[1]:
            break
        pieces += [audio, gap]
        refs.append(e["ipa_transcription"])
    long_audio = np.concatenate(pieces[:-1])
    seconds = len(long_audio) / SAMPLE_RATE
    require(LEARN_LONG[0] <= seconds <= LEARN_LONG[1], "learn: long input "
            "of 45-60 s")
    for mode in ("batched", "sequential"):
        reset_counts(torch)
        t0 = time.time()
        res = transcribe(params, cfg, long_audio, language="en",
                         word_timestamps=True, tokenizer=tok, kv_int8=True,
                         sequential_timestamps=mode == "sequential")
        wall = time.time() - t0
        launches = by_path[f"learn transcribe {mode}"] = read_counts(torch)
        segs = res["segments"]
        phones = [p for s in segs for p in s.get("phones", [])]
        per = phone_error_rate("".join(refs), res["text"].replace(" ", ""))
        # the checkpoint was trained without timestamps (every row
        # <|notimestamps|>): which branch the sequential mode took where
        kinds = (f"; windows (start s, temperature, branch) "
                 f"{[(round(w['start'], 2), w['temperature'], w['branch']) for w in res['windows']]}"
                 if mode == "sequential" else "")
        log(f"[learn transcribe {mode}] {seconds:.2f} s of {len(refs)} "
            f"held-out utterances, int8 cache, phone timestamps: wall "
            f"{wall:.2f} s; {len(segs)} segments "
            f"{[(round(s['start'], 2), round(s['end'], 2)) for s in segs]}, "
            f"temperatures {[s['temperature'] for s in segs]}, texts "
            f"{[s['text'] for s in segs]}, {len(phones)} phones; PER against "
            f"the joined references {per:.2f}%{kinds}; launches "
            f"{nonzero(launches)}")
        require(launches["K4"] > 0, f"learn transcribe {mode}: K4 ran")
        if mode == "batched":
            n_windows = int(np.ceil(seconds / 30.0))
            require(len(segs) == n_windows and all(s["text"].strip()
                                                  for s in segs),
                    "learn transcribe batched: text in every window")
            require(all(0.0 <= s["start"] <= s["end"] <= seconds
                        for s in segs + phones),
                    "learn transcribe batched: segment and phone bounds "
                    "within the audio")

    # examples/torch_perturbed_eval.py's conditions on the held-out split
    # (its unseen speaker and snr10+reverb run in phase_examples)
    options = DecodingOptions(language=None, without_timestamps=True,
                              length_penalty=1.0, sample_len=64)
    reset_counts(torch)
    scores = {}
    for cond in ("clean", "snr20", "snr10", "reverb"):
        t0 = time.time()
        m = device_decode_scores(params, cfg, tok, heldout, options, cond)
        scores[cond] = (m["per"], m["pfer"], time.time() - t0)
    by_path["learn perturbed"] = read_counts(torch)
    log("[learn perturbed] 48 held-out utterances, language detected, 64 "
        "tokens: " + "; ".join(
            f"{c} PER {p:.2f}% PFER {f:.2f}% ({w:.2f} s)"
            for c, (p, f, w) in scores.items()))
    require(all(np.isfinite(v[:2]).all() for v in scores.values()),
            "learn: perturbed scores finite")
    wall = time.time() - t_phase
    log(f"[learn] phase passed in {wall:.1f} s")
    return dict(floor=floor, train=train_score, summary=summary, wall=wall,
                ckpt=ckpt, params=params, tok=tok, train_json=train_json,
                heldout=heldout, heldout_json=heldout_json, cache=cache,
                run=out, console=console)


# -- speculative decoding (decode/speculative.py, decode/medusa_tree.py) ----

SPEC_K = 4  # draft tokens a round (chain); DEFAULT_TREE is 4 deep
SPEC_FLOOR_LEN = 16  # tokens a row for the unrelated draft (the floor:
# ~1 token a round, so its wall grows with the tokens)
SPEC_TRAIN_STEPS = 200  # cli.train_medusa and cli.distill_draft
SPEC_HTTP = 8  # held-out requests through each speculative server


def spec_masks(torch, dev, tok, options, n_vocab):
    """decode()'s suppress and first-token blank masks for ``options``."""
    from whisper_ipa_torch.decode import build_blank_mask, build_suppress_mask

    return (torch.from_numpy(build_suppress_mask(tok, options, n_vocab)).to(dev),
            torch.from_numpy(build_blank_mask(tok, n_vocab)).to(dev))


def spec_decoders(cfg, params, draft, heads):
    """name -> (fn(mel, options, tok) -> (results, stats), the draft's
    encoder layers): a self-draft, an unrelated draft (``draft``, a
    (params, cfg) pair, where given), n-gram, a Medusa chain and tree."""
    from whisper_ipa_torch.decode import medusa_tree_decode, speculative_decode
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE

    def chain(draft_params, draft_cfg, medusa=None):
        return lambda mel, o, tok: speculative_decode(
            params, cfg, draft_params, draft_cfg, mel, o, draft_k=SPEC_K,
            tokenizer=tok, return_stats=True, medusa_params=medusa)

    unrelated = ({} if draft is None else
                 {"unrelated draft": (chain(*draft), draft[1].n_audio_layer)})
    return {
        "self-draft": (chain(params, cfg), cfg.n_audio_layer),
        **unrelated,
        "n-gram": (chain(None, None), 0),
        "medusa chain": (chain(None, None, heads), 0),
        "medusa tree": (lambda mel, o, tok: medusa_tree_decode(
            params, cfg, heads, mel, o, tree=DEFAULT_TREE, tokenizer=tok,
            return_stats=True), 0),
    }


def spec_run(torch, dev, cfg, audio, fn, options, tok):
    """waveform -> log-mel (K1) -> fn, launches counted from 0 and the wall
    on the host clock, synchronised. Returns (mel, results, stats, wall,
    launches)."""
    from whisper_ipa_torch.ops import log_mel_spectrogram

    reset_counts(torch)
    t0 = time.time()
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    out = fn(mel, options, tok)
    torch.cuda.synchronize()
    wall = time.time() - t0
    results, stats = out if isinstance(out, tuple) else (out, None)
    return mel, results, stats, wall, read_counts(torch)


# the verify profile's windows nearly always lose a record or a few (1 of
# 320 to ~60 of 22,600 on an H100), and each window retried costs ~1.5 s:
# a window short of a whole count a call by up to this share is taken
# (its depth cut for the script's wall)
VERIFY_LOST = 0.05


def verify_profile(torch, dev, cfg, params, batch: int):
    """torch.profiler device time of one chain verification forward (K + 1
    queries a row at position n_prefix + 32, bf16, int8 cross cache) and
    of its plain int8 cross-attention over every decoder layer (the work a
    multi-query K4 would take), beside one single-query step and K4 over
    the same cache."""
    from whisper_ipa_torch.models import (cast_decoder_blocks, decode_step,
                                          decode_step_multipos_hidden,
                                          encode, init_cache)
    from whisper_ipa_torch.models.layers import multi_head_attention_int8kv

    dtype, n_prefix = torch.bfloat16, 4
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)).to(dev)
    out = {}
    with torch.inference_mode():
        p = cast_decoder_blocks(params, dtype)
        feats = encode(params, cfg, mel, dtype=dtype)
        cache = init_cache(p, cfg, feats, max_len=n_prefix + MAIN_SAMPLE_LEN
                           + SPEC_K + 1, dtype=dtype, cross_kv_int8=True)
        tokens = torch.full((batch, SPEC_K + 1), 300, device=dev)
        pos = torch.full((batch,), n_prefix + 32, device=dev)
        out["verify_ms"], out["verify_kernels"] = device_profile(
            torch, lambda: decode_step_multipos_hidden(
                p, cfg, tokens, cache, pos, dtype=dtype), iters=20,
            lost=VERIFY_LOST)
        out["step_ms"], out["step_kernels"] = device_profile(
            torch, lambda: decode_step(p, cfg, tokens[:, :1], cache,
                                       n_prefix + 32, dtype=dtype), iters=20,
            lost=VERIFY_LOST)
        d = cfg.n_text_state
        for name, s in (("plain_cross_ms", SPEC_K + 1), ("k4_cross_ms", 1)):
            q = torch.randn((batch, s, d), device=dev, dtype=dtype)
            out[name] = cfg.n_text_layer * device_profile(
                torch, lambda: multi_head_attention_int8kv(
                    q, cache.cross_k[0], cache.cross_k_scale[0],
                    cache.cross_v[0], cache.cross_v_scale[0], cfg.n_text_head),
                iters=20, lost=VERIFY_LOST)[0]
    return {k: round(v, 4) for k, v in out.items()}


class TreeDrift:
    """Wraps ``medusa_tree.tree_round`` while a tree decode runs. Each round
    re-feeds the R = K + 2 newest context rows, positions max(lens - R, 0)
    to lens - 1, and writes their self K/V again. The rows below the
    previous round's lens (the prefix pass's at the first round) already
    held the K/V an earlier forward wrote from the same tokens at the same
    positions; it reads those rows before and after each round."""

    def __init__(self, mt):
        self.mt = mt
        self.rounds = self.rows = self.changed = 0
        self.max_dk = self.max_dv = 0.0

    def __enter__(self):
        self.orig, self.prev = self.mt.tree_round, None
        self.mt.tree_round = self.round
        return self

    def __exit__(self, *exc):
        self.mt.tree_round = self.orig

    def round(self, *args, **kw):
        # (params, heads, cfg, cache, tokens_buf, hidden, lens, suppress,
        #  blank, n_prefix, tree, dtype) and tp, as _tree_decode passes them
        cache, lens, tree = args[3], args[6].tolist(), args[10]
        R = self.mt._tree_tables(tuple(tuple(n) for n in tree))[5] + 2
        prev = self.prev or lens
        saved = [(b, max(n - R, 0), p, cache.self_k[:, b, max(n - R, 0):p].clone(),
                  cache.self_v[:, b, max(n - R, 0):p].clone())
                 for b, (n, p) in enumerate(zip(lens, prev)) if p > max(n - R, 0)]
        out = self.orig(*args, **kw)
        for b, lo, hi, k, v in saved:
            dk = float((out[0].self_k[:, b, lo:hi].float() - k.float()).abs().max())
            dv = float((out[0].self_v[:, b, lo:hi].float() - v.float()).abs().max())
            self.max_dk, self.max_dv = max(self.max_dk, dk), max(self.max_dv, dv)
            self.rows += hi - lo
            self.changed += bool(dk or dv)
        self.prev = lens
        self.rounds += 1
        return out

    def summary(self) -> str:
        return (f"{self.rounds} calls of tree_round, {self.rows} re-fed rows written "
                f"before: max |dK| {self.max_dk:.3e}, |dV| {self.max_dv:.3e}, "
                f"row-rounds changed {self.changed}")


def phase_speculative_parity(torch, dev, tok):
    """test-tiny in f32 with the int8 cache: the draft-model, n-gram, Medusa
    chain and tree tokens on the card equal the CPU's (and decode()'s)."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.models import init_params, params_to
    from whisper_ipa_torch.models.medusa import init_medusa_params

    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
    mel = np.random.default_rng(4).standard_normal((2, 64, cfg.n_mels)).astype(
        np.float32)
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=16, kv_int8=True)
    cpu = (init_params(cfg, seed=0), init_params(cfg, seed=7),
           init_medusa_params(cfg, SPEC_K, seed=1))
    tokens = {}
    for where, (p, d, h) in (("cpu", cpu), ("cuda", tuple(
            params_to(t, dev) for t in cpu))):
        for name, (fn, _) in spec_decoders(cfg, p, (d, cfg), h).items():
            if name == "self-draft":
                continue
            res, _ = fn(mel, opts, tok)
            tokens[(where, name)] = [r.tokens for r in res]
        tokens[(where, "decode")] = [r.tokens for r in decode(
            p, cfg, mel, opts, tokenizer=tok)]
    names = sorted({n for _, n in tokens})
    same = {n: tokens[("cpu", n)] == tokens[("cuda", n)]
            == tokens[("cpu", "decode")] for n in names}
    log(f"[speculative parity] test-tiny f32 int8 cross-KV, 2 rows x 16 "
        f"tokens, K {SPEC_K}: CUDA == CPU == decode() tokens {same}")
    require(all(same.values()), "test-tiny speculative tokens equal on CUDA, "
            "on the CPU and decode()'s")


def phase_speculative(torch, dev, cfg, params, tok, by_path,
                      card: str) -> float:
    """Speculative decoding at whisper-small's full width on the serving
    phases' batch (16 x 30 s, 64 tokens, EOT suppressed, bf16, int8 cross
    cache, K 4): a self-draft (the acceptance ceiling), an unrelated
    whisper-tiny draft from seed 1 (the floor, at SPEC_FLOOR_LEN tokens a
    row: its depth cut for the script's wall), n-gram, a Medusa chain on
    init_medusa_params heads and a Medusa tree on DEFAULT_TREE; each held
    to decode() under the near-tie rule, K1/K2/K4/K8 launches equal to the
    prediction; the self-draft in f32 at batch 2; the drift of the tree's
    re-fed K/V rows in bf16 and f32 (TreeDrift); the verification
    forward's device time; test-tiny CUDA against the CPU. Returns the
    unrelated draft's seconds (its warm-up, run and checks)."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.decode import medusa_tree as mt
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.medusa import init_medusa_params

    t_phase = time.time()
    phase_speculative_parity(torch, dev, tok)
    tiny = CONFIGS["tiny"]
    draft = (init_params(tiny, seed=1, device=dev), tiny)
    heads = init_medusa_params(cfg, SPEC_K, seed=0, device=dev)
    modes = spec_decoders(cfg, params, draft, heads)
    floor_s = 0.0
    prefix = list(tok.sot_sequence_including_notimestamps)
    audio = torch.from_numpy(synthetic_audio(MAIN_BATCH, 30.0, seed=1)).to(dev)

    def decode_fn(mel, o, t):
        return decode(params, cfg, mel, o, tokenizer=t)

    for bf16, batch in ((True, MAIN_BATCH), (False, 2)):
        t_pass = time.time()
        options = DecodingOptions(
            language="en", without_timestamps=True,
            sample_len=MAIN_SAMPLE_LEN, suppress_tokens=[-1, tok.eot],
            fp16=bf16, kv_int8=True)
        dtype = torch.bfloat16 if bf16 else torch.float32
        suppress, blank = spec_masks(torch, dev, tok, options, cfg.n_vocab)
        runs = {"decode": decode_fn} | ({k: v[0] for k, v in modes.items()}
                                        if bf16 else
                                        {"self-draft": modes["self-draft"][0]})
        lens = {name: SPEC_FLOOR_LEN if name == "unrelated draft"
                else MAIN_SAMPLE_LEN for name in runs}
        short = replace(options, sample_len=8)
        out = {}
        for name, fn in runs.items():
            t0 = time.time()
            # warm-up: cuBLAS handles, the allocator
            spec_run(torch, dev, cfg, audio[:batch], fn, short, tok)
            out[name] = spec_run(torch, dev, cfg, audio[:batch], fn,
                                 replace(options, sample_len=lens[name]), tok)
            if name == "unrelated draft":
                floor_s += time.time() - t0
        mel, oracle, _, decode_wall, _ = out.pop("decode")
        mels = [mel[i:i + 1] for i in range(batch)]
        eps = (2.0 * step0_delta(torch, cfg, params, mels[:EPS_WINDOWS], prefix)
               if bf16 else EPS_F32)
        precision = "bf16" if bf16 else "f32"
        log(f"[speculative] whisper-small {precision}, batch {batch} x 30 s, "
            f"{MAIN_SAMPLE_LEN} tokens a row (EOT suppressed), int8 cross "
            f"cache, K {SPEC_K}, on {card}: decode() wall {decode_wall:.4f} "
            f"s; near-tie eps {eps:.4e}")
        for name, (_, results, stats, wall, launches) in out.items():
            t0, n = time.time(), lens[name]
            want = {"K1": 1, "K2": cfg.n_audio_layer + modes[name][1] if bf16
                    else 0, "K4": 0, "K8": 0}
            got = {k: launches[k] for k in want}
            rows = [(f"row {i}", r.tokens, o.tokens[:n], mels[i], False)
                    for i, (r, o) in enumerate(zip(results, oracle))]
            equal, near, gaps = hold_to_decode(
                torch, cfg, params, tok, rows, prefix, suppress, blank, dtype,
                eps, f"speculative {name} {precision}")
            against = (f"against decode()'s {decode_wall:.4f} s "
                       f"({wall / decode_wall:.3f}x)" if n == MAIN_SAMPLE_LEN
                       else f"({n} tokens a row: decode()'s first {n} held)")
            log(f"[speculative {name} {precision}] rounds {stats.rounds}, "
                f"tokens a round {stats.tokens_per_round:.4f} ({stats.emitted_tokens} "
                f"tokens), wall {wall:.4f} s {against}; {equal} rows "
                f"equal decode()'s, {near} leave it at a near-tie (gaps {gaps}); "
                f"launches {nonzero(launches)}, predicted {want}")
            require(all(len(r.tokens) == n for r in results)
                    and stats.emitted_tokens == batch * n,
                    f"speculative {name}: every row decoded {n} tokens")
            require(got == want, f"speculative {name} {precision}: launches "
                    f"{got}, predicted {want}")
            by_path[f"speculative {name} {precision}"] = launches
            if name == "unrelated draft":
                floor_s += time.time() - t0
        # the tree's re-feed rewrites rows it wrote before: read once, on
        # a run of its own, outside the timed ones
        with TreeDrift(mt) as drift:
            spied, _ = modes["medusa tree"][0](mel, options, tok)
        same = (out["medusa tree"][1] if bf16 else None)
        log(f"[speculative tree re-feed {precision}] batch {batch}, "
            f"DEFAULT_TREE, R {SPEC_K + 2}: {drift.summary()}"
            + ("" if same is None else
               f"; tokens equal the timed run's "
               f"{[r.tokens for r in spied] == [r.tokens for r in same]}"))
        require(drift.rounds > 0 and drift.rows > 0,
                f"the tree re-feed spy read rows ({precision})")
        if bf16:
            ceiling = out["self-draft"][2].tokens_per_round
            require(ceiling > 1.5, f"the self-draft accepts: {ceiling:.3f} "
                    f"tokens a round")
        log(f"[speculative {precision}] pass wall {time.time() - t_pass:.1f} s")
    t0 = time.time()
    prof = verify_profile(torch, dev, cfg, params, MAIN_BATCH)
    log(f"[speculative verify profile] ({time.time() - t0:.1f} s) "
        f"whisper-small bf16 int8 cache, batch "
        f"{MAIN_BATCH}, torch.profiler device time: one verification forward "
        f"of {SPEC_K + 1} queries a row {prof['verify_ms']} ms "
        f"({prof['verify_kernels']} kernels), one single-query step "
        f"{prof['step_ms']} ms ({prof['step_kernels']} kernels); the plain "
        f"int8 cross-attention of the verification over "
        f"{cfg.n_text_layer} layers {prof['plain_cross_ms']} ms, K4's "
        f"single-query cross-attention {prof['k4_cross_ms']} ms")
    del draft, heads
    torch.cuda.empty_cache()
    log(f"[speculative] phase passed in {time.time() - t_phase:.1f} s")
    return floor_s


def phase_speculative_learned(torch, dev, root: str, learned: dict, by_path):
    """On phase_learn's whisper-tiny checkpoint: cli.train_medusa (4 heads,
    200 steps, the accuracy file), cli.distill_draft (a test-tiny student,
    200 steps, bf16: K2 forward for student and teacher, K5 backward for
    the student), then the 48 held-out utterances decoded with the trained
    chain, the trained tree (tree_for_heads), the distilled draft, the
    untrained heads and the undistilled student, each held to decode() by
    the near-tie rule; then cli.serve --draft-model ngram and --draft-model
    medusa --medusa-tree over HTTP, the latter also with --continuous."""
    from whisper_ipa_torch.audio import load_audio, pad_or_trim
    from whisper_ipa_torch.cli import distill_draft, train_medusa
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.decode.medusa_tree import tree_for_heads
    from whisper_ipa_torch.models import init_params, load_checkpoint_auto
    from whisper_ipa_torch.models.medusa import init_medusa_params, load_medusa
    from whisper_ipa_torch.ops import log_mel_spectrogram

    t_phase = time.time()
    cfg, params, tok = CONFIGS["tiny"], learned["params"], learned["tok"]
    common = ["--train-data", learned["train_json"], "--batch-size", "16",
              "--mel-cache-dir", learned["cache"], "--log-every", "50",
              "--device", dev.type]
    heads_path = os.path.join(root, "heads.safetensors")
    reset_counts(torch)
    t0 = time.time()
    probs = train_medusa.main([
        "--model", "tiny", "--checkpoint", learned["ckpt"], "--full-checkpoint",
        "--n-heads", str(SPEC_K), "--steps", str(SPEC_TRAIN_STEPS),
        "--output", heads_path, *common])
    heads_s, launches = time.time() - t0, read_counts(torch)
    by_path["learn train_medusa"] = launches
    want = {"K1": 0, "K2": cfg.n_audio_layer * (SPEC_TRAIN_STEPS + 4), "K5": 0}
    got = {k: launches[k] for k in want}
    log(f"[learn train_medusa] {SPEC_K} heads, {SPEC_TRAIN_STEPS} steps, batch "
        f"16, frozen whisper-tiny checkpoint: {heads_s:.1f} s; per-head top-4 "
        f"accuracy {[[round(x, 4) for x in row] for row in probs]}; launches "
        f"{nonzero(launches)}, predicted {want}")
    require(got == want, f"train_medusa launches {got}, predicted {want}")
    require(os.path.isfile(heads_path + ".accuracy.json"),
            "train_medusa wrote the accuracy file")

    student_cfg = CONFIGS["test-tiny"]
    out_dir = os.path.join(root, "draft")
    reset_counts(torch)
    t0 = time.time()
    # ten times the CLI's default rate: a test-tiny student from random
    # init moves little in 200 steps at 1e-4
    student_ckpt = distill_draft.main([
        "--student", "test-tiny", "--teacher", "tiny", "--teacher-checkpoint",
        learned["ckpt"], "--full-checkpoint", "--output-dir", out_dir,
        "--steps", str(SPEC_TRAIN_STEPS), "--save-every", "0",
        "--learning-rate", "1e-3", *common])
    distill_s, launches = time.time() - t0, read_counts(torch)
    by_path["learn distill_draft"] = launches
    want = {"K1": 0, "K2": (student_cfg.n_audio_layer + cfg.n_audio_layer)
            * SPEC_TRAIN_STEPS, "K5": student_cfg.n_audio_layer * SPEC_TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    log(f"[learn distill_draft] test-tiny student from the whisper-tiny "
        f"teacher, {SPEC_TRAIN_STEPS} steps, batch 16, lr 1e-3, bf16, token "
        f"width 128: "
        f"{distill_s:.1f} s; launches {nonzero(launches)}, predicted {want}")
    require(got == want, f"distill_draft launches {got}, predicted {want}")

    # the held-out split, batches of 16 (48 rows: three)
    heldout = learned["heldout"]
    waves = [pad_or_trim(load_audio(e["audio_path"])) for e in heldout]
    with torch.inference_mode():
        mels = [log_mel_spectrogram(torch.from_numpy(np.stack(
            waves[i:i + 16])).to(dev), n_mels=cfg.n_mels)
            for i in range(0, len(waves), 16)]
    options = DecodingOptions(language="en", without_timestamps=True,
                              sample_len=MAIN_SAMPLE_LEN, fp16=True,
                              kv_int8=True)
    suppress, blank = spec_masks(torch, dev, tok, options, cfg.n_vocab)
    prefix = list(tok.sot_sequence_including_notimestamps)
    oracle = [r.tokens for m in mels
              for r in decode(params, cfg, m, options, tokenizer=tok)]
    rows_mel = [m[i:i + 1] for m in mels for i in range(m.shape[0])]
    eps = 2.0 * step0_delta(torch, cfg, params, rows_mel[:EPS_WINDOWS], prefix)
    trained = load_medusa(heads_path, device=dev)
    tree = tree_for_heads(heads_path)
    student, _ = load_checkpoint_auto(student_ckpt, init_params(
        student_cfg, seed=0, device=dev))
    from whisper_ipa_torch.decode import medusa_tree_decode, speculative_decode

    def chain(draft_params=None, draft_cfg=None, heads=None):
        return lambda m: speculative_decode(
            params, cfg, draft_params, draft_cfg, m, options, draft_k=SPEC_K,
            tokenizer=tok, return_stats=True, medusa_params=heads)

    modes = {
        "untrained heads": chain(heads=init_medusa_params(cfg, SPEC_K, seed=0,
                                                          device=dev)),
        "trained heads": chain(heads=trained),
        "trained tree": lambda m: medusa_tree_decode(
            params, cfg, trained, m, options, tree=tree, tokenizer=tok,
            return_stats=True),
        "undistilled student": chain(init_params(student_cfg, seed=0,
                                                 device=dev), student_cfg),
        "distilled student": chain(student, student_cfg),
    }
    tpr = {}
    for name, fn in modes.items():
        reset_counts(torch)
        t0 = time.time()
        outs = [fn(m) for m in mels]
        torch.cuda.synchronize()
        wall = time.time() - t0
        by_path[f"learn speculative {name}"] = read_counts(torch)
        got = [r.tokens for res, _ in outs for r in res]
        rounds = sum(st.rounds * st.batch for _, st in outs)
        tpr[name] = sum(st.emitted_tokens for _, st in outs) / rounds
        equal, near, gaps = hold_to_decode(
            torch, cfg, params, tok,
            [(f"utterance {i}", g, w, m, False)
             for i, (g, w, m) in enumerate(zip(got, oracle, rows_mel))],
            prefix, suppress, blank, torch.bfloat16, eps,
            f"learn speculative {name}")
        log(f"[learn speculative {name}] {len(got)} held-out utterances, bf16, "
            f"int8 cache: {sum(st.rounds for _, st in outs)} rounds over "
            f"{len(outs)} batches, tokens a round {tpr[name]:.4f} (a finished "
            f"row counts in its batch's rounds), wall {wall:.3f} s; "
            f"{equal} equal decode()'s, {near} leave it at a near-tie (gaps "
            f"{gaps}; eps {eps:.4e})")
    log(f"[learn speculative] tokens a round: trained heads "
        f"{tpr['trained heads']:.4f} against untrained {tpr['untrained heads']:.4f}, "
        f"trained tree {tpr['trained tree']:.4f} (tree {tree}); distilled "
        f"student {tpr['distilled student']:.4f} against undistilled "
        f"{tpr['undistilled student']:.4f}")
    require(tpr["trained heads"] >= tpr["untrained heads"],
            "trained heads reach at least the untrained heads' tokens a round")

    phase_speculative_http(torch, dev, learned, heads_path, prefix, eps)
    log(f"[learn speculative] phase passed in {time.time() - t_phase:.1f} s")


def phase_speculative_http(torch, dev, learned, heads_path, prefix, eps):
    """cli.serve on the whisper-tiny checkpoint, one request a batch: plain,
    --draft-model ngram (a plain service, as the reference's), and
    --draft-model medusa with the trained heads and --medusa-tree, in the
    micro-batch service and in the in-flight engine (--continuous, one
    slot, the service's 224-token budget). Each answer equals the same
    decoder called directly on the request's batch (the engine's
    transcribe()). The ngram texts equal the plain server's; the trees'
    equal them except where their tokens leave decode() at a near-tie,
    which the near-tie rule holds on those direct calls' tokens."""
    import threading
    from types import SimpleNamespace

    from whisper_ipa_torch.audio import load_audio, pad_or_trim
    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    cfg, params, tok = CONFIGS["tiny"], learned["params"], learned["tok"]
    paths = [e["audio_path"] for e in learned["heldout"][:SPEC_HTTP]]
    base = ["--model", "tiny", "--checkpoint", learned["ckpt"],
            "--full-checkpoint", "--batch-size", "1", "--port", "0",
            "--device", dev.type]
    texts, direct = {}, {}
    tree = ["--draft-model", "medusa", "--medusa-weights", heads_path,
            "--medusa-tree"]
    for name, extra in (("plain", []), ("ngram", ["--draft-model", "ngram"]),
                        ("medusa tree", tree),
                        ("continuous medusa tree", tree + [
                            "--continuous", "--max-new-tokens", "224"])):
        server, service = serve_cli.build_server(base + extra)
        if name == "plain":
            options = service.options  # bf16, the int8 cross cache
        url = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            texts[name] = [_http(f"{url}/transcribe", json.dumps(
                {"path": p}).encode(), "application/json")[0]["text"]
                for p in paths]
            direct[name] = []
            for p in paths:
                audio = pad_or_trim(load_audio(p))
                with torch.inference_mode():
                    mel = log_mel_spectrogram(torch.from_numpy(audio)[None].to(
                        dev), n_mels=cfg.n_mels)
                if "continuous" in name:
                    out = service.transcribe(audio, timeout=300)
                    res = SimpleNamespace(text=out["text"], tokens=out["tokens"])
                else:
                    res = service._decode_windows([audio])[0]
                direct[name].append((mel, res))
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=30)
        require(not thread.is_alive() and not service._thread.is_alive(),
                f"serve {name}: threads stopped")
        require(texts[name] == [r.text for _, r in direct[name]],
                f"serve {name}: each answer equals the direct call's")
    require(options.fp16 and options.kv_int8, "the serving options")
    suppress, blank = spec_masks(torch, dev, tok, options, cfg.n_vocab)
    plain = [(m, r.tokens) for m, r in direct["plain"]]
    require([decode(params, cfg, m, options, tokenizer=tok)[0].tokens
             for m, _ in plain] == [t for _, t in plain],
            "the plain server decodes as decode() on the checkpoint")
    for name in ("ngram", "medusa tree", "continuous medusa tree"):
        equal, near, gaps = hold_to_decode(
            torch, cfg, params, tok,
            [(f"request {i}", r.tokens, want, m, False)
             for i, ((m, want), (_, r)) in enumerate(zip(plain, direct[name]))],
            prefix, suppress, blank, torch.bfloat16, eps, f"serve {name}")
        same = [a == b for a, b in zip(texts[name], texts["plain"])]
        tie_free = [r.tokens == want
                    for (_, want), (_, r) in zip(plain, direct[name])]
        log(f"[learn serve {name}] cli.serve"
            f"{' --continuous' if 'continuous' in name else ''} --draft-model "
            f"{name.split()[-2] if 'tree' in name else name}"
            f"{' --medusa-tree' if 'tree' in name else ''}, {SPEC_HTTP} "
            f"held-out requests: {sum(same)} texts equal the plain server's; "
            f"tokens {equal} equal decode()'s, {near} at a near-tie (gaps "
            f"{gaps})")
        # n-gram drafts serve only in the in-flight engine: under ngram the
        # service decodes plainly, as the reference's does, so its texts
        # are the plain server's. The tree verifies in bf16 blocks, which
        # may leave greedy decoding at a near-tie (held above); every other
        # request's text is the plain server's
        require(all(same) if name == "ngram" else
                all(s for s, t in zip(same, tie_free) if t),
                f"serve {name}: texts equal the plain server's")


# -- data preparation, zero-shot evaluation, tools (the host modules) ----------

PREP_LANGS = ("ja", "pl", "mt", "hu", "fi", "el", "ta")
PREP_GOOD = 12  # rows a language that pass every filter but the 6 s one
PREP_SPLITS = (("train", 8, "combined_train_ipa.json"),
               ("dev", 4, "combined_val_ipa.json"),
               ("test", 2, "combined_test_ipa.json"))


def prep_graphemes(lang: str) -> list:
    """Letters of the language's converter, each of which converts alone."""
    from whisper_ipa_torch.data.prep.g2p import japanese, languages, tamil

    if lang == "ja":
        return [k for k in japanese._BASE if k not in "ぁぃぅぇぉゐゑ"]
    if lang == "ta":
        return [k for k in list(tamil._INDEP) + list(tamil._CONS)
                if k != "ச"]  # ச drops a sentence (the reference's rule)
    return [k for k in languages.CONVERTERS[lang].table
            if k.isalpha() and len(k) == 1]


def write_cv_fixture(root: str, lang: str, seed: int) -> list:
    """A CommonVoice-style language directory (<lang>/{train,dev,test}.tsv,
    clips/ of synthesized WAVs) and its rows as (sentence, seconds, kept by
    the filters): PREP_GOOD sentences of 1-3 words over the converter's
    letters with clips of 1-8 s (the 6 s filter drops the longer), a
    sentence with a quote character, and one row for each filter: a URL, a
    duplicate, a one-character sentence, down_votes 2, an empty cell
    (Tamil: also a sentence with ச)."""
    from whisper_ipa_torch.audio import write_wav
    from whisper_ipa_torch.data.synth import synthesize_phonemes

    rng = np.random.default_rng(seed)
    letters = prep_graphemes(lang)

    def word():
        return "".join(rng.choice(letters, size=int(rng.integers(2, 6))))

    good = []
    while len(good) < PREP_GOOD:
        s = " ".join(word() for _ in range(int(rng.integers(1, 4))))
        if s not in good:
            good.append(s)
    # (sentence, seconds, down_votes, kept by the quality filters)
    rows = [(s, float(rng.uniform(1.0, 8.0)), "0", True) for s in good]
    rows += [(good[0] + ' "' + word(), 2.0, "0", True),
             (good[1] + " https://example.org", 2.0, "0", False),
             (good[2], 2.0, "1", False),  # the duplicate
             (letters[0], 2.0, "0", False),
             (good[3] + word(), 2.0, "2", False),
             ("", 2.0, "0", False)]
    if lang == "ta":
        rows.append((good[4] + " சக", 2.0, "0", True))
    d = os.path.join(root, lang)
    os.makedirs(os.path.join(d, "clips"), exist_ok=True)
    for i, (_, seconds, _, _) in enumerate(rows):
        voice = synthesize_phonemes(["a", "m", "i"], seed=seed * 100 + i)
        audio = np.zeros(int(seconds * SAMPLE_RATE), np.float32)
        audio[:min(len(voice), len(audio))] = voice[:len(audio)]
        write_wav(os.path.join(d, "clips", f"{lang}{i}.wav"), audio)
    lines = ["client_id\tpath\tsentence\tup_votes\tdown_votes"]
    lines += [f"spk{i % 4}\t{lang}{i}.wav\t{s}\t2\t{dv}"
              for i, (s, _, dv, _) in enumerate(rows)]
    for split, _, _ in PREP_SPLITS:
        with open(os.path.join(d, f"{split}.tsv"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return [(s, sec, ok) for s, sec, _, ok in rows]


def write_aligned_fixtures(root: str) -> None:
    """One utterance each of a TIMIT, a METU and an OGI layout."""
    from whisper_ipa_torch.audio import write_wav

    wav = np.zeros(SAMPLE_RATE // 10, np.float32)
    timit = os.path.join(root, "timit")
    for split in ("TRAIN", "TEST"):
        d = os.path.join(timit, split, "DR1", "FAKE0")
        os.makedirs(d)
        write_wav(os.path.join(d, "SA1.WAV"), wav)
        with open(os.path.join(d, "SA1.PHN"), "w") as f:
            f.write("0 100 h#\n100 200 k\n200 300 ae\n300 400 t\n400 500 h#\n")
    metu = os.path.join(root, "metu", "data")
    for sub in ("speech-text", "alignments"):
        os.makedirs(os.path.join(metu, sub, "s1"))
    write_wav(os.path.join(metu, "speech-text", "s1", "u1.wav"), wav)
    with open(os.path.join(metu, "alignments", "s1", "u1.phn"), "w") as f:
        f.write("0 1 SIL\n1 2 GG\n2 3 UE\n3 4 LL\n")
    ogi = os.path.join(root, "ogi")
    for sub in ("handlabl", "speech"):
        os.makedirs(os.path.join(ogi, sub, "call", "a"))
    write_wav(os.path.join(ogi, "speech", "call", "a", "x.wav"), wav)
    with open(os.path.join(ogi, "handlabl", "call", "a", "x.ptl"), "w") as f:
        f.write("MillisecondsPerFrame: 3.0\nEND OF HEADER\n0 100 h#\n"
                "100 200 k\n200 300 ao-r\n")


def prep_prediction(lang: str, rows: list, n: int, seed: int = 42) -> int:
    """Entries process_language writes for a split of ``n``: the rows the
    quality and 6 s filters keep, in file order, n of them drawn as
    DataFrame.sample(n, random_state=seed) draws them where there are
    more, then those whose sentence converts (Tamil: none with ச)."""
    from whisper_ipa_torch.data.prep import text_to_ipa

    kept = [s for s, seconds, ok in rows if ok and seconds <= 6.0]
    if len(kept) > n:
        kept = [kept[i] for i in np.random.RandomState(seed).choice(
            len(kept), n, replace=False)]
    count = 0
    for s in kept:
        if lang == "ta" and "ச" in s:
            continue
        try:
            count += bool(text_to_ipa(s, lang))
        except ValueError:
            pass
    return count


def phase_prep(root: str) -> None:
    """The data-preparation CLIs on the card's machine, which has neither
    pandas nor openpyxl: cli.check_vocab; cli.prepare_datasets g2p on a
    seeded CommonVoice-style fixture of the seven G2P languages, its
    per-language counts against a prediction made from the fixture; verify
    on its output; timit, metu, ogi and combine on one-utterance layouts."""
    from whisper_ipa_torch.cli import check_vocab, prepare_datasets
    from whisper_ipa_torch.data.prep import analyze_dataset

    t_phase = time.time()
    require(check_vocab.main([]) == 0, "cli.check_vocab returns 0")
    cv = os.path.join(root, "cv")
    predicted, clips = {}, 0
    for k, lang in enumerate(PREP_LANGS):
        rows = write_cv_fixture(cv, lang, seed=900 + k)
        clips += len(rows)
        predicted[lang] = {split: prep_prediction(lang, rows, n)
                           for split, n, _ in PREP_SPLITS}
    out = os.path.join(root, "processed")
    t0 = time.time()
    prepare_datasets.main([
        "g2p", "--dataset-root", cv, "--output-dir", out, "--languages",
        *PREP_LANGS, "--train-n", "8", "--val-n", "4", "--test-n", "2"])
    g2p_s = time.time() - t0
    counts = {lang: {} for lang in PREP_LANGS}
    files = []
    for split, _, name in PREP_SPLITS:
        files.append(os.path.join(out, name))
        with open(files[-1], encoding="utf-8") as f:
            for e in json.load(f):
                counts[e["locale"]][split] = counts[e["locale"]].get(split, 0) + 1
    counts = {lang: {s: c.get(s, 0) for s, _, _ in PREP_SPLITS}
              for lang, c in counts.items()}
    prepare_datasets.main(["verify", *files])
    needs = [len(analyze_dataset(p)[1]) for p in files]

    aligned = os.path.join(root, "aligned")
    write_aligned_fixtures(aligned)
    processed = os.path.join(root, "aligned_processed")
    prepare_datasets.main(["timit", "--timit-root", os.path.join(aligned, "timit"),
                           "--output-dir", processed])
    prepare_datasets.main(["metu", "--metu-root", os.path.join(aligned, "metu"),
                           "--output", os.path.join(processed,
                                                    "metu_turkish_ipa.json")])
    prepare_datasets.main(["ogi", "--ogi-root", os.path.join(aligned, "ogi"),
                           "--output", os.path.join(processed,
                                                    "ogi_spelled_ipa.json")])
    prepare_datasets.main(["combine", "--processed-dir", processed])
    with open(os.path.join(processed, "combined_train_ipa.json")) as f:
        combined = json.load(f)
    with open(os.path.join(processed, "combined_test_ipa.json")) as f:
        combined_test = json.load(f)
    absent = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("pandas", "openpyxl"))
    log(f"[prep] cli.check_vocab 0; cli.prepare_datasets g2p on {clips} "
        f"synthesized clips of {len(PREP_LANGS)} languages in {g2p_s:.1f} s: "
        f"(train, val, test) a language {({k: tuple(v.values()) for k, v in counts.items()})}, "
        f"predicted from the fixture "
        f"{({k: tuple(v.values()) for k, v in predicted.items()})}; verify: "
        f"entries needing NFC a file {needs}; combine: "
        f"{[e['dataset_source'] for e in combined]} train, "
        f"{len(combined_test)} test, IPA {[e['ipa_transcription'] for e in combined]}; "
        f"pandas/openpyxl modules loaded {absent}; phase {time.time() - t_phase:.1f} s")
    require(counts == predicted, "prepare_datasets g2p: per-language counts "
            "as predicted from the fixture")
    require(sum(c["train"] for c in counts.values()) > 7 * 4,
            "prepare_datasets g2p: most languages fill their train split")
    require([e["dataset_source"] for e in combined]
            == ["timit", "metu_turkish", "ogi_spelled"]
            and [e["ipa_transcription"] for e in combined]
            == ["kæt", "ɟyɫ", "kɔɹ"] and len(combined_test) == 1,
            "timit, metu, ogi and combine")
    require(not absent, "the data preparation loaded neither pandas nor "
            "openpyxl")


ZS_POOR = (41, 75, 80)  # zeroshot.py's poor-quality ids: both, Ariga, Hamanishi
# large-v3's entries (its --num-samples and --batch-size): 2 keeps the
# script within two minutes of its wall before the zero-shot phase
ZS_LARGE = 2


def zeroshot_decode(torch, dev, params, cfg, entries, batch: int):
    """The CLI's hypotheses computed here: each entry's log-mel on the card
    (K1), batches of ``batch``, decode() with the CLI's options and
    tokenizer."""
    from whisper_ipa_torch.audio import load_audio, pad_or_trim
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.metrics import normalize_ipa_for_comparison
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=cfg.multilingual,
                        num_languages=cfg.num_languages, language="en")

    options = DecodingOptions(language=None, without_timestamps=True)
    hyps = []
    for start in range(0, len(entries), batch):
        with torch.inference_mode():
            mels = torch.stack([
                log_mel_spectrogram(torch.from_numpy(pad_or_trim(load_audio(
                    e["audio_path"]))).to(dev), n_mels=cfg.n_mels)
                for e in entries[start:start + batch]])
        hyps += [normalize_ipa_for_comparison(r.text.strip())
                 for r in decode(params, cfg, mels, options, tokenizer=tok)]
    return hyps


def phase_zeroshot(torch, dev, root: str, learned: dict, by_path) -> None:
    """The zero-shot pipeline on phase_learn's 48 held-out utterances: two
    annotator sheets written with utils.xlsx (A the synthesizer's IPA, B A
    with a seeded one-phone substitution in every fourth entry; ids 41, 75
    and 80 poor-quality), a test_data.csv that agrees with A and a WAV dir;
    cli.parse_zeroshot_test (A gold, usable pairs as predicted),
    cli.compute_iaa (equal to evaluate_batch on the usable pairs), then
    cli.evaluate_zeroshot on the card with its defaults (language
    detected, f32, float cache, batch 8) on the whisper-tiny checkpoint,
    and at its default --base-model, large-v3 at random init (seed 0), on
    ZS_LARGE entries; each hypothesis equal to decode()'s on the same
    log-mels, launches as predicted."""
    from whisper_ipa_torch.cli import (compute_iaa, evaluate_zeroshot,
                                       parse_zeroshot_test)
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.metrics import (evaluate_batch,
                                           normalize_ipa_for_comparison,
                                           tokenize_ipa)
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.utils.xlsx import write_xlsx

    t_phase = time.time()
    heldout = learned["heldout"]
    phone_set = example("torch_generalization").PHONES
    ids = list(range(1, len(heldout) + 1))
    ids[-2:] = ZS_POOR[1:]  # 41 is already among 1..48
    rng = np.random.default_rng(77)
    a_rows = [["ID", "IPA", "Elapsed Time (sec)"]]
    b_rows = [["ID", "IPA", "Elapsed Time (sec)"]]
    wav_dir = os.path.join(root, "zeroshot_wav")
    os.makedirs(wav_dir)
    for i, (entry_id, e) in enumerate(zip(ids, heldout)):
        ipa = e["ipa_transcription"]
        phones = tokenize_ipa(ipa)
        if i % 4 == 3:
            j = int(rng.integers(len(phones)))
            phones[j] = next(p for p in rng.permutation(phone_set)
                             if p != phones[j])
        b_ipa = "?" if i == 5 else "".join(phones)  # "?": no annotation
        a_rows.append([float(entry_id), ipa, float(10 + i)])
        b_rows.append([float(entry_id), b_ipa, float(20 + i)])
        shutil.copy(e["audio_path"], os.path.join(wav_dir,
                                                  f"{entry_id}_utt{i}.wav"))
    sheets = {k: os.path.join(root, f"IPA_annotation_sheet_{k}.xlsx")
              for k in ("Ariga", "Hamanishi")}
    write_xlsx(sheets["Ariga"], a_rows)
    write_xlsx(sheets["Hamanishi"], b_rows)
    csv_path = os.path.join(root, "test_data.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("ID,IPA,Done\n" + "".join(
            f"{int(r[0])},{r[1]},1\n" for r in a_rows[1:]))
    zs_json = os.path.join(root, "zeroshot_test.json")
    data = parse_zeroshot_test.main([
        "--ariga-xlsx", sheets["Ariga"], "--hamanishi-xlsx",
        sheets["Hamanishi"], "--test-data-csv", csv_path, "--wav-dir",
        wav_dir, "--output", zs_json])
    usable = [e for e in data if e["usable_for_iaa"]]
    want_usable = len(heldout) - len(ZS_POOR) - 1  # the poor ids, the "?"
    require(all(e["gold_annotator"] == "ariga" for e in data)
            and len(usable) == want_usable
            and all(e["audio_path"] for e in data),
            f"parse_zeroshot_test: Ariga gold, {want_usable} usable pairs, "
            "every WAV found")

    iaa = compute_iaa.main(["--input", zs_json])
    refs = [normalize_ipa_for_comparison(e["ipa_ariga"]) for e in usable]
    hyps = [normalize_ipa_for_comparison(e["ipa_hamanishi"]) for e in usable]
    direct = {"ariga_ref": evaluate_batch(refs, hyps),
              "hamanishi_ref": evaluate_batch(hyps, refs)}
    gaps = [abs(iaa[side][k] - direct[side][m])
            for side in direct for k, m in (("per", "per"),
                                            ("pfer_hamming", "pfer"))]
    log(f"[zeroshot iaa] {len(data)} entries, {len(usable)} usable: Ariga as "
        f"reference PER {iaa['ariga_ref']['per']:.4f}% PFER-Hamming "
        f"{iaa['ariga_ref']['pfer_hamming']:.4f}% PFER-cosine "
        f"{iaa['ariga_ref']['pfer_cosine']:.4f}%; largest gap to "
        f"evaluate_batch {max(gaps):.3e}")
    require(iaa["num_pairs"] == want_usable and max(gaps) <= 1e-9,
            "compute_iaa equals evaluate_batch on the usable pairs")

    # whisper-tiny, the learned checkpoint, the CLI's defaults
    cfg = CONFIGS["tiny"]
    n_batches = -(-len(data) // 8)
    want = {"K1": len(data), "K2": 0, "K4": 0}  # f32: K2 takes bf16 only
    reset_counts(torch)
    t0 = time.time()
    res = evaluate_zeroshot.main(["--test-data", zs_json, "--base-model",
                                  "tiny", "--checkpoint", learned["ckpt"]])
    wall = time.time() - t0
    launches = by_path["evaluate_zeroshot tiny"] = read_counts(torch)
    ours = zeroshot_decode(torch, dev, learned["params"], cfg, [
        e for e in data if e["gold_ipa"] and e["audio_path"]], batch=8)
    summary = learned["summary"]
    log(f"[zeroshot tiny] cli.evaluate_zeroshot --base-model tiny on the "
        f"learned checkpoint, {len(res['hypotheses'])} entries in {n_batches} "
        f"batches of 8, language detected, f32, float cache: PER "
        f"{res['per']:.2f}% PFER {res['pfer']:.2f}% (phase_learn's clean "
        f"held-out PER {summary['final_per']:.2f}% PFER "
        f"{summary['final_pfer']:.2f}%), wall {wall:.2f} s; hypotheses equal "
        f"decode()'s {res['hypotheses'] == ours}; launches "
        f"{nonzero(launches)}, predicted {want}")
    require(res["hypotheses"] == ours, "evaluate_zeroshot tiny: hypotheses "
            "equal decode()'s on the same log-mels")
    require({k: launches[k] for k in want} == want,
            "evaluate_zeroshot tiny: K1 a entry, no K2 (f32), no K4")
    require(res["pfer"] <= 60.0, "evaluate_zeroshot tiny: PFER <= 60%")

    # large-v3 at random init: the CLI's default --base-model
    cfg = CONFIGS["large-v3"]
    want = {"K1": ZS_LARGE, "K2": 0, "K4": 0}
    reset_counts(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = evaluate_zeroshot.main(["--test-data", zs_json, "--num-samples",
                                  str(ZS_LARGE), "--batch-size",
                                  str(ZS_LARGE)])
    wall = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = by_path["evaluate_zeroshot large-v3"] = read_counts(torch)
    torch.cuda.empty_cache()
    t0 = time.time()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    entries = [e for e in data if e["gold_ipa"] and e["audio_path"]][:ZS_LARGE]
    t0 = time.time()
    ours = zeroshot_decode(torch, dev, params, cfg, entries, batch=ZS_LARGE)
    decode_s = time.time() - t0
    del params
    torch.cuda.empty_cache()
    log(f"[zeroshot large-v3] cli.evaluate_zeroshot at its default "
        f"--base-model (large-v3, {cfg.n_mels} mels, {cfg.num_languages} "
        f"languages, random init from seed 0), {ZS_LARGE} entries in one "
        f"batch, language detected, f32: wall {wall:.2f} s (init_params on "
        f"the host generator {init_s:.2f} s, the same decode in process "
        f"{decode_s:.2f} s), peak {peak_gb:.2f} GB; PER {res['per']:.2f}% "
        f"PFER {res['pfer']:.2f}%; hypothesis lengths "
        f"{[len(h) for h in res['hypotheses']]}; equal decode()'s "
        f"{res['hypotheses'] == ours}; launches {nonzero(launches)}, "
        f"predicted {want}")
    require(res["hypotheses"] == ours, "evaluate_zeroshot large-v3: "
            "hypotheses equal decode()'s on the same log-mels")
    require({k: launches[k] for k in want} == want,
            "evaluate_zeroshot large-v3: K1 a entry, no K2 (f32), no K4")
    log(f"[zeroshot] phase passed in {time.time() - t_phase:.1f} s")


def phase_tools(torch, dev, learned: dict, by_path) -> None:
    """cli.benchmark_models (counts; --measure at tiny and small, batch 8),
    cli.profile_inference (decode at small, batch 8, 32 tokens; the train
    step at small, with cached features, and at tiny batch 16) with the
    port's kernels' launches as predicted, and cli.calculate_real_speed on
    phase_learn's run and console log."""
    import re

    from whisper_ipa_torch.cli import (benchmark_models, calculate_real_speed,
                                       profile_inference)
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.utils.flops import peak_flops

    t_phase = time.time()
    t0 = time.time()
    reports = benchmark_models.main(["--models", "tiny", "base", "small",
                                     "medium"])
    counts = {r["model"]: r["total_params"] for r in reports}
    log(f"[tools benchmark_models] parameters {counts} in "
        f"{time.time() - t0:.1f} s")
    require(reports[2]["decoder_params"] == 153_580_800,
            "benchmark_models: whisper-small's decoder has the reference's "
            "153,580,800 parameters")

    reset_counts(torch)
    t0 = time.time()
    reports = benchmark_models.main(["--models", "tiny", "small", "--measure",
                                     "--batch-size", "8"])
    launches = by_path["benchmark_models --measure"] = read_counts(torch)
    for r in reports:
        log(f"[tools benchmark_models --measure] {r['model']}: train step "
            f"(frozen encoder, f32, batch 8, mean of 5 after a warm-up) "
            f"{r['train_step_sec'] * 1e3:.2f} ms, "
            f"{r['train_samples_per_sec']:.2f} samples/s, MFU "
            f"{r.get('train_mfu', float('nan')):.4%} (f32 step over the "
            f"bf16 peak)")
    log(f"[tools benchmark_models --measure] launches {nonzero(launches)} "
        f"in {time.time() - t0:.1f} s")
    if peak_flops(torch.cuda.get_device_name(dev)) is not None:
        require(all(r.get("train_mfu", 0) > 0 for r in reports),
                "benchmark_models --measure: MFU against the card's peak")
    require(launches["K2"] == 0 and launches["K5"] == 0,
            "benchmark_models --measure: f32 and a frozen encoder: no K2, "
            "no K5")

    small, tiny = CONFIGS["small"], CONFIGS["tiny"]
    for name, argv, want in (
        ("decode", ["--model", "small", "--batch", "8", "--sample-len", "32"],
         {"K1": 1, "K2/K10": small.n_audio_layer,
          "K4": 31 * small.n_text_layer}),
        ("train", ["--model", "small", "--batch", "8", "--train"],
         {"K2/K10": small.n_audio_layer}),
        ("train cached", ["--model", "small", "--batch", "8", "--train",
                          "--cached-features"], {}),
        ("train tiny", ["--model", "tiny", "--batch", "16", "--train"],
         {"K2/K10": tiny.n_audio_layer}),
    ):
        reset_counts(torch)
        t0 = time.time()
        res = profile_inference.main(argv + ["--top", "8"])
        counts = by_path[f"profile_inference {name}"] = read_counts(torch)
        got = {k: v["launches"] for k, v in res["port_kernels"].items()}
        log(f"[tools profile_inference {name}] device {res['device']}: "
            f"profiled run {res['wall_s'] * 1e3:.2f} ms, device total "
            f"{res['total_ms']:.2f} ms, busy {res['busy_share']:.1%}; port "
            f"kernels {res['port_kernels']}; top "
            f"{[(r['op'][:50], round(r['self_ms'], 3), r['occurrences']) for r in res['rows'][:5]]}; "
            f"counters (warm-up and profiled run) {nonzero(counts)}; "
            f"{time.time() - t0:.1f} s")
        require(got == want, f"profile_inference {name}: the port's kernels "
                f"{got}, predicted {want}")
        require(res["total_ms"] / 1e3 <= res["wall_s"],
                f"profile_inference {name}: device total within the wall")

    ps = shutil.which("ps")
    steps = LEARN_STEPS
    est = calculate_real_speed.main([str(os.getpid()), learned["run"],
                                     str(steps), str(LEARN_BATCH),
                                     "--log-file", learned["console"]])
    with open(learned["console"], encoding="utf-8") as f:
        rates = [float(m.group(1)) for m in (
            re.match(r"Step \d+/\d+ \|.*\| Samples/sec: ([0-9.]+)$", ln.strip())
            for ln in f) if m][-20:]
    log(f"[tools calculate_real_speed] ps at {ps}; estimate {est}; the "
        f"log's last {len(rates)} Samples/sec values average "
        f"{float(np.mean(rates)) if rates else float('nan'):.4f}")
    if est is None:
        log("[tools calculate_real_speed] the process runtime is unknown "
            "(no ps): the estimate is None, as the reference's")
        require(ps is None, "calculate_real_speed: an estimate where ps runs")
    else:
        require(est.get("step") == steps, "calculate_real_speed: the latest "
                f"checkpoint is step {steps}")
        require(len(rates) == 20 and abs(
            est["recent_samples_per_sec"] - float(np.mean(rates))) < 1e-9,
            "calculate_real_speed: the log's samples/s")
    log(f"[tools] phase passed in {time.time() - t_phase:.1f} s")



# -- the example programs (examples/torch_*.py) ------------------------------

EXAMPLE_LOCALES = ("ja", "pl", "mt", "hu", "fi", "el", "ta")  # the corpus's
EXAMPLE_CORPUS = (32, 8)  # train and test entries of corpus_scale's corpus
EXAMPLE_STEPS = 20  # corpus_scale's training steps, 4 a chunk


def write_reference_corpus(ref_dir: str, train: list, heldout: list) -> None:
    """combined_{train,test}_ipa.json in the reference corpus's schema
    (ipa_transcription, speaker_id, locale) from the learning set's
    transcriptions: EXAMPLE_CORPUS entries, 8 speakers, the seven locales
    in turn."""
    os.makedirs(ref_dir)
    for split, entries, n in (("train", train, EXAMPLE_CORPUS[0]),
                              ("test", heldout, EXAMPLE_CORPUS[1])):
        rows = [{"ipa_transcription": e["ipa_transcription"],
                 "speaker_id": f"spk{i % 8}",
                 "locale": EXAMPLE_LOCALES[i % len(EXAMPLE_LOCALES)]}
                for i, e in enumerate(entries[:n])]
        with open(os.path.join(ref_dir, f"combined_{split}_ipa.json"),
                  "w") as f:
            json.dump(rows, f, ensure_ascii=False)


def phase_examples(torch, dev, root: str, learned: dict, by_path) -> dict:
    """The port's example programs through their mains, on the card, on
    phase_learn's whisper-tiny checkpoint and held-out split:
    torch_corpus_report (the split with the seven locales in turn, a fresh
    mel cache filled by K1), torch_perturbed_eval on the two conditions
    phase_learn does not run (the unseen speaker, snr10+reverb),
    torch_inference_latency at whisper-small, torch_minimal_finetune (its
    loss falls) and torch_corpus_scale (tiny, EXAMPLE_STEPS steps in
    chunks of 4, bf16, on a corpus in the reference's schema). Each run
    timed, its launches counted; returns the walls."""
    t_phase = time.time()
    ckpt, run = learned["ckpt"], learned["run"]
    walls, runs = {}, {}

    def timed(name, argv, module):
        reset_counts(torch)
        t0 = time.time()
        runs[name] = example(module).main(argv)
        walls[name] = round(time.time() - t0, 2)
        by_path[f"examples {name}"] = launches = read_counts(torch)
        log(f"[examples {name}] wall {walls[name]:.2f} s; launches "
            f"{nonzero(launches)}")
        return launches

    data = os.path.join(root, "heldout_locales.json")
    with open(data, "w") as f:
        json.dump([dict(e, locale=EXAMPLE_LOCALES[i % len(EXAMPLE_LOCALES)])
                   for i, e in enumerate(learned["heldout"])], f,
                  ensure_ascii=False)
    n = len(learned["heldout"])
    launches = timed("corpus_report", [
        "--run-dir", run, "--checkpoint", ckpt, "--data", data, "--model",
        "tiny", "--mel-cache-dir", os.path.join(root, "melcache_report"),
        "--out", os.path.join(root, "corpus_report.json")],
        "torch_corpus_report")
    report = runs["corpus_report"]
    log("[examples corpus_report] " + "; ".join(
        f"{loc} n {m['n']} PER {m['per']:.2f}% PFER {m['pfer']:.2f}%"
        for loc, m in report["by_locale"].items())
        + f"; overall PER {report['overall']['per']:.2f}% PFER "
        f"{report['overall']['pfer']:.2f}%, phone accuracy "
        f"{report['phone_accuracy'] * 100:.2f}%, top substitutions "
        f"{report['top_substitutions'][:3]}")
    require(report["n_scored"] == n
            and sorted(report["by_locale"]) == sorted(EXAMPLE_LOCALES)
            and sum(m["n"] for m in report["by_locale"].values()) == n,
            "corpus_report: every utterance scored once, seven locales")
    require(report["overall"]["pfer"] <= 60.0,
            "corpus_report: held-out PFER <= 60%, as phase_learn's gate")
    require(launches["K1"] == -(-n // 16),
            "corpus_report: K1 filled the fresh mel cache, 16 a launch")

    launches = timed("perturbed_eval", [
        "--run-dir", run, "--checkpoint", ckpt, "--data",
        learned["heldout_json"], "--model", "tiny", "--conditions",
        "speaker", "snr10+reverb", "--out",
        os.path.join(root, "perturbed_eval.json")], "torch_perturbed_eval")
    conds = runs["perturbed_eval"]["conditions"]
    log("[examples perturbed_eval] 48 held-out utterances: " + "; ".join(
        f"{c} PER {m['per']:.2f}% PFER {m['pfer']:.2f}% ({m['elapsed_s']} s)"
        for c, m in conds.items()))
    require(list(conds) == ["speaker", "snr10+reverb"]
            and all(np.isfinite([m["per"], m["pfer"]]).all()
                    for m in conds.values()),
            "perturbed_eval: speaker and snr10+reverb scores finite")
    require(launches["K1"] == 2 * -(-n // 16),
            "perturbed_eval: K1 once a batch of 16 a condition")

    launches = timed("inference_latency", ["small"],
                     "torch_inference_latency")
    lat = runs["inference_latency"]
    require(lat["steady_s"] > 0 and launches["K1"] >= 2,
            "inference_latency: two transcriptions, K1 in each")

    timed("minimal_finetune", [], "torch_minimal_finetune")
    losses = runs["minimal_finetune"]
    require(len(losses) == 5 and all(np.isfinite(losses))
            and losses[-1] < losses[0],
            "minimal_finetune: five finite losses, the last under the first")

    ref_dir = os.path.join(root, "reference_corpus")
    with open(learned["train_json"]) as f:
        write_reference_corpus(ref_dir, json.load(f), learned["heldout"])
    launches = timed("corpus_scale", [
        "--model", "tiny", "--steps", str(EXAMPLE_STEPS), "--batch-size",
        "16", "--steps-per-call", "4", "--bf16", "--val-samples",
        str(EXAMPLE_CORPUS[1]), "--validate-every", "10", "--save-every",
        str(EXAMPLE_STEPS), "--out", os.path.join(root, "corpus"),
        "--ref-dir", ref_dir], "torch_corpus_scale")
    scale = runs["corpus_scale"]
    log(f"[examples corpus_scale] {json.dumps(scale)}")
    require(scale["n_train"] == EXAMPLE_CORPUS[0]
            and np.isfinite([scale["final_loss"], scale["heldout_per"],
                             scale["floor_per"]]).all(),
            "corpus_scale: its three stages ran, finite scores")
    require(launches["K1"] == sum(-(-k // 16) for k in EXAMPLE_CORPUS),
            "corpus_scale: K1 filled the mel cache, 16 a launch")
    require(launches["K5"] == 4 * EXAMPLE_STEPS
            and launches["K2"] >= 4 * EXAMPLE_STEPS,
            "corpus_scale: K2 forward and K5 backward in every step")
    walls["phase"] = round(time.time() - t_phase, 1)
    log(f"[examples] phase passed in {walls['phase']:.1f} s: {walls}")
    return walls


# -- parallel: torch.distributed over the one card ---------------------------

PARALLEL_TP = 2
PARALLEL_STEPS = 2
PARALLEL_LR = 1e-5  # the CLI's default rate
PARALLEL_FT_BATCH = 4  # the TP full fine-tune's batch
PARALLEL_TIMEOUT = 900  # seconds the two ranks may take together
PARALLEL_SLOTS = 8  # the engine over two ranks: 8 slots (4 a rank at DP=2)
PARALLEL_MAX_NEW = 24  # tokens a window in the engine and service paths
PARALLEL_REQUESTS = 6  # the seeded stream the mesh paths share
PARALLEL_SVC_BATCH = 4  # the service's batch: its first 4 requests
# the adaptive engine's long chunk: 8 x 4 = 32 steps; a slot has at most
# PARALLEL_MAX_NEW - 1 = 23 tokens left after its join's 1-step chunk, so
# the all-halted check (every 4th step) stops every long chunk early
PARALLEL_ADAPTIVE_MULT = 8


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_nccl_one_rank(torch, dev) -> dict:
    """(a) ``parallel.initialize`` on cuda with world 1 and NCCL named: the
    collective helpers' identities on CUDA tensors (f32 and bf16, the
    coalesced ones too), then the group is destroyed."""
    import torch.distributed as dist

    from whisper_ipa_torch.parallel import distributed as D
    from whisper_ipa_torch.parallel import initialize
    from whisper_ipa_torch.parallel import sharded as S

    initialize(f"localhost:{free_port()}", 1, 0, device=dev, backend="nccl")
    try:
        backend = dist.get_backend()
        require(backend == "nccl", f"one-rank backend {backend}")
        held = []
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((6, 8), device=dev).to(dtype)
            y = torch.randn((4, 6), device=dev).to(dtype)
            for name, got in (
                ("all_reduce", D.all_reduce(x.clone())),
                ("all_gather", D.all_gather(x, dim=1)),
                ("reduce_scatter", D.reduce_scatter(x.clone(), dim=0)),
                ("broadcast", D.broadcast(x.clone(), src=0)),
            ):
                require(torch.equal(got, x), f"NCCL {name} {dtype} identity")
            for got, want in zip(S.all_gather_coalesced([x, y], [1, 0], None)
                                 + S.reduce_scatter_coalesced([x, y], [0, 1], None)
                                 + S.all_reduce_coalesced([x, y], None),
                                 [x, y] * 3):
                require(torch.equal(got, want), f"NCCL coalesced {dtype} identity")
            held.append(str(dtype)[6:])
        torch.cuda.synchronize()
        version = ".".join(str(v) for v in torch.cuda.nccl.version())
    finally:
        dist.destroy_process_group()
    log(f"[parallel nccl] one rank on {torch.cuda.get_device_name(0)}: "
        f"backend {backend}, NCCL {version}; all_reduce, all_gather, "
        f"reduce_scatter ({'reduce_scatter_single' if hasattr(dist, 'reduce_scatter_single') else 'reduce_scatter_tensor'}), "
        f"broadcast and the coalesced gather/scatter/reduce are identities "
        f"on CUDA tensors ({', '.join(held)})")
    return dict(backend=backend, nccl=version)


def parallel_kernel_checks(torch, dev, heads: int) -> dict:
    """K2, K4 and K5 held to their plain versions at the local shapes the
    ranks' paths give them (``heads`` = whisper-small's 12 / tp): K2 at the
    TP decode's (16 * heads, 1500, 64), the fine-tune's (4 * heads, ...),
    and a joining window's under TP and DP (1 * heads and 1 * 12), K4 at
    the TP decode's (16, heads, 1, 64) and the engine's (8, heads), (4,
    12) and (4, heads) over T_pad 1536, K5 at the fine-tune's (4 * heads,
    1500, 64), bf16, with chip_smoke's bounds (K2 5e-3 or one bf16 ulp, K4
    2% of max|out|, K5 1e-2 of max|grad|)."""
    from whisper_ipa_torch.ops import attention as at
    from whisper_ipa_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    out = {}
    full = heads * PARALLEL_TP
    for batch, h in ((MAIN_BATCH, heads), (PARALLEL_FT_BATCH, heads),
                     (1, heads), (1, full)):
        q, k, v = (torch.randn((batch, h, 1500, 64), generator=gen,
                               device=dev).to(bf) for _ in range(3))
        got = at.fused_attention(q, k, v, 0.125)
        want = at.attention_plain(q, k, v, 0.125)
        require(bf16_within(got, want, 5e-3), f"K2 ({batch}*{h}) bf16")
        out[f"K2 ({batch}*{h}, 1500, 64)"] = max_abs(got, want)
    q, k, v, g = (torch.randn((PARALLEL_FT_BATCH, heads, 1500, 64), generator=gen,
                              device=dev).to(bf) for _ in range(4))
    o, lse = at._forward_kernel(q, k, v, 0.125, with_lse=True)
    got = at.attention_backward(q, k, v, o, g, lse, 0.125)
    want = at.attention_backward_plain(q, k, v, g, 0.125)
    rel = max(max_abs(a, b) / float(b.float().abs().max())
              for a, b in zip(got, want))
    require(rel < 1e-2, f"K5 ({PARALLEL_FT_BATCH}*{heads}) bf16")
    out[f"K5 ({PARALLEL_FT_BATCH}*{heads}, 1500, 64)"] = rel
    for b, h in ((MAIN_BATCH, heads), (PARALLEL_SLOTS, heads),
                 (PARALLEL_SLOTS // 2, full), (PARALLEL_SLOTS // 2, heads)):
        kc, vc = (torch.randint(-127, 128, (b, h, 64, 1536), generator=gen,
                                device=dev).to(torch.int8) for _ in range(2))
        ks, vs = (0.01 + 0.02 * torch.rand((b, h, 1536), generator=gen,
                                           device=dev) for _ in range(2))
        ks[..., 1500:] = 0.0
        vs[..., 1500:] = 0.0
        q = (torch.randn((b, h, 1, 64), generator=gen, device=dev)
             * 0.125).to(bf)
        got = da.decode_cross_attention_int8_tminor(q, kc, ks, vc, vs)
        want = da.decode_attention_plain(q, kc, ks, vc, vs)
        err = max_abs(got, want)
        require(err <= 0.02 * float(want.float().abs().max()),
                f"K4 ({b}, {h}) bf16")
        out[f"K4 ({b}, {h}, 1, 64)"] = err
    torch.cuda.synchronize()
    return out


def parallel_batch(cfg, batch: int, seed: int):
    """Seeded log-mel-scale inputs and token rows with 2-9 text tokens
    (the ranks' valid-token counts differ)."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((batch, 2 * cfg.n_audio_ctx, cfg.n_mels))
    eot = 50257
    tokens = np.full((batch, 16), eot, np.int64)
    tokens[:, :4] = [50258, 50259, 50359, 50363]
    for i in range(batch):
        n = 2 + i % 8
        tokens[i, 4:4 + n] = rng.integers(100, 5000, n)
    return mel.astype(np.float32), tokens, eot


def parallel_agree(got: dict, want: dict, start: dict) -> dict:
    """How far a parallel run's parameters are from the one-rank run's,
    against how far the one-rank run moved them: max and mean |diff| and
    mean |update| over the trained tensors."""
    diff = upd = mx = 0.0
    n = 0
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs()
        diff += float(d.sum())
        mx = max(mx, float(d.max()))
        upd += float((w.float() - start[name].float()).abs().sum())
        n += d.numel()
    return dict(max_diff=mx, mean_diff=diff / n, mean_update=upd / n)


def parallel_rank_body(torch, rank: int) -> dict:
    """(b) One rank of the two sharing the card (gloo): the local-shape
    kernel checks, then each path with its launches counted from 0."""
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.decode.decoding import (build_blank_mask,
                                                   build_suppress_mask,
                                                   initial_tokens)
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.convert import flatten_params, unflatten_params
    from whisper_ipa_torch.ops import log_mel_spectrogram
    from whisper_ipa_torch.parallel import (fsdp_param_shardings, make_mesh,
                                            opt_state_shardings,
                                            param_shardings, shard_params)
    from whisper_ipa_torch.parallel import distributed as D
    from whisper_ipa_torch.parallel.mesh import (place_params, replicate,
                                                 shard_chunk)
    from whisper_ipa_torch.tokenizer import get_tokenizer
    from whisper_ipa_torch.train import create_train_state, train_step
    from whisper_ipa_torch.train.step import (create_train_state_zero1,
                                              make_zero1_step)

    dev = torch.device("cuda", 0)
    cfg = CONFIGS["small"]
    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    host = init_params(cfg, seed=0)  # drawn once on the host, copied per path

    def fresh():
        return unflatten_params({n: t.to(dev, copy=True)
                                 for n, t in flatten_params(host).items()})
    heads = cfg.n_text_head // PARALLEL_TP
    out = dict(rank=rank, checks=parallel_kernel_checks(torch, dev, heads),
               paths={}, shapes={}, walls={})

    # TP=2 greedy decoding at the serving setting
    mesh = make_mesh(model=PARALLEL_TP)
    params = shard_params(mesh, fresh(), tensor_parallel=True)
    options = DecodingOptions(
        language="en", without_timestamps=True, sample_len=MAIN_SAMPLE_LEN,
        suppress_tokens=[-1, tok.eot], fp16=True, kv_int8=True)
    audio = torch.from_numpy(synthetic_audio(MAIN_BATCH, 30.0, seed=1)).to(dev)
    reset_counts(torch)
    t0 = time.time()
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    results = decode(params, cfg, mel, options, tokenizer=tok, tp=mesh.tp)
    torch.cuda.synchronize()
    out["walls"]["tp2 decode"] = time.time() - t0
    out["paths"]["tp2 decode"] = read_counts(torch)
    out["shapes"]["tp2 decode"] = dict(
        K1=[MAIN_BATCH, 480000], K2=[MAIN_BATCH * heads, 1500, 64],
        K4=[MAIN_BATCH, heads, 1, 64],
        query_w=list(params["decoder"]["blocks"][0]["attn"]["query"]["w"].shape))
    tp_tokens = [r.tokens for r in results]
    del params
    if rank == 0:
        full = fresh()
        one = [r.tokens for r in decode(full, cfg, mel, options, tokenizer=tok)]
        prefix = initial_tokens(tok, options)
        suppress = torch.from_numpy(build_suppress_mask(
            tok, options, cfg.n_vocab)).to(dev)
        blank = torch.from_numpy(build_blank_mask(tok, cfg.n_vocab)).to(dev)
        eps = 2 * step0_delta(torch, cfg, full,
                              [mel[i:i + 1] for i in range(EPS_WINDOWS)], prefix)
        rows = [(f"row {i}", tp_tokens[i], one[i], mel[i:i + 1], False)
                for i in range(MAIN_BATCH)]
        equal, ties, gaps = hold_to_decode(torch, cfg, full, tok, rows, prefix,
                                           suppress, blank, torch.bfloat16,
                                           eps, "tp2 decode")
        out["decode"] = dict(rows_equal=equal, near_ties=ties, gaps=gaps, eps=eps)
        del full
    torch.cuda.empty_cache()

    # decoder-only training steps over data 2: DP, ZeRO-1, FSDP
    mel_np, tokens_np, eot = parallel_batch(cfg, TRAIN_BATCH, seed=5)
    kw = dict(learning_rate=PARALLEL_LR, freeze_encoder=True)
    ref = {}
    if rank == 0:  # the one-rank run on the global batch
        state, tx = create_train_state(fresh(), **kw)
        start = {n: t.clone() for n, t in flatten_params(state.params).items()
                 if tx.trainable(n)}
        losses = []
        for _ in range(PARALLEL_STEPS):
            state, loss = train_step(
                state, torch.from_numpy(mel_np).to(dev, torch.bfloat16),
                torch.from_numpy(tokens_np).to(dev), cfg, tx, eot,
                dtype_name="bfloat16")
            losses.append(float(loss))
        ref = dict(losses=losses, start=start,
                   params={n: t for n, t in flatten_params(state.params).items()
                           if n in start})
        del state
    for kind in ("dp", "zero1", "fsdp"):
        mesh = make_mesh(data=2)
        p = fresh()
        sh = None
        if kind == "fsdp":
            sh = fsdp_param_shardings(mesh, p)
            p = place_params(replicate(mesh, p), sh)
        else:
            p = replicate(mesh, p)
        if kind == "dp":
            state, tx = create_train_state(p, **kw)
            osh = opt_state_shardings(mesh, tx, p, zero1=False)
        else:
            state, tx, osh = create_train_state_zero1(mesh, p, **kw)
        # the chunked form train() runs over a mesh: the global batch
        # PARALLEL_STEPS times, the rank's rows of each step cut at once
        step = make_zero1_step(mesh, cfg, tx, eot, osh, param_shardings=sh,
                               chunk=True, freeze_encoder=True,
                               dtype_name="bfloat16")
        m, t = shard_chunk(
            mesh, torch.from_numpy(np.stack([mel_np] * PARALLEL_STEPS)).to(
                torch.bfloat16),
            torch.from_numpy(np.stack([tokens_np] * PARALLEL_STEPS)))
        reset_counts(torch)
        t0 = time.time()
        state, losses = step(state, m, t)
        losses = losses.tolist()
        torch.cuda.synchronize()
        out["walls"][f"{kind} dp2 train"] = time.time() - t0
        out["paths"][f"{kind} dp2 train"] = read_counts(torch)
        name = "decoder.blocks.0.mlp1.w"
        out["shapes"][f"{kind} dp2 train"] = dict(
            rows=list(m.shape), mu=list(state.opt_state.mu[name].shape),
            param=list(flatten_params(state.params)[name].shape))
        whole = {n: state.layout.params[n].gather(v)
                 for n, v in flatten_params(state.params).items()
                 if tx.trainable(n)}
        if rank == 0:
            out[f"{kind} dp2 train"] = dict(
                losses=losses, ref_losses=ref["losses"],
                **parallel_agree(whole, ref["params"], ref["start"]))
        del state, whole, p
        torch.cuda.empty_cache()
    ref = {}

    # a TP=2 full fine-tune step: K5 on the local heads
    mel_np, tokens_np, eot = parallel_batch(cfg, PARALLEL_FT_BATCH, seed=7)
    kw = dict(learning_rate=PARALLEL_LR, freeze_encoder=False)
    mel_t = torch.from_numpy(mel_np).to(dev, torch.bfloat16)
    tok_t = torch.from_numpy(tokens_np).to(dev)
    if rank == 0:
        state, tx = create_train_state(fresh(), **kw)
        start = {n: t.clone() for n, t in flatten_params(state.params).items()}
        state, loss = train_step(state, mel_t, tok_t, cfg, tx, eot,
                                 freeze_encoder=False, dtype_name="bfloat16")
        ref = dict(losses=[float(loss)], start=start,
                   params=flatten_params(state.params))
        del state
    mesh = make_mesh(model=PARALLEL_TP)
    p = shard_params(mesh, fresh(), tensor_parallel=True)
    state, tx = create_train_state(p, **kw)
    osh = opt_state_shardings(mesh, tx, p, tensor_parallel=True, zero1=False)
    step = make_zero1_step(mesh, cfg, tx, eot, osh,
                           param_shardings=param_shardings(mesh, p),
                           freeze_encoder=False, dtype_name="bfloat16")
    reset_counts(torch)
    t0 = time.time()
    state, loss = step(state, mel_t, tok_t)
    torch.cuda.synchronize()
    out["walls"]["tp2 full fine-tune"] = time.time() - t0
    out["paths"]["tp2 full fine-tune"] = read_counts(torch)
    out["shapes"]["tp2 full fine-tune"] = dict(
        K2=[PARALLEL_FT_BATCH * heads, 1500, 64],
        K5=[PARALLEL_FT_BATCH * heads, 1500, 64])
    whole = {n: state.layout.params[n].gather(v)
             for n, v in flatten_params(state.params).items()}
    if rank == 0:
        out["tp2 full fine-tune"] = dict(
            losses=[float(loss)], ref_losses=ref["losses"],
            **parallel_agree(whole, ref["params"], ref["start"]))
    del state, whole, p, ref
    torch.cuda.empty_cache()

    parallel_engine_paths(torch, rank, dev, cfg, tok, fresh, out)
    out["staged"] = sorted(D.STAGED)
    return out


def parallel_mesh_run(torch, eng, clips, gaps) -> dict:
    """Rank 0 submits the stream at its gaps (tokens streamed by window)
    while the other ranks follow; each rank counts its launches from 0
    before its first command (no barrier: rank 0's engine thread may
    broadcast an idle beat at any time). Returns the launches, the wall
    and stats, and on rank 0 the results and each request's tokens by
    window."""
    reset_counts(torch)
    t0 = time.time()
    out = {}
    if eng._thread is None:
        eng.follow()
    else:
        futs, streamed = [], []
        for clip, gap in zip(clips, gaps):
            by_window = {}

            def on_token(d, by_window=by_window):
                by_window.setdefault(d["window"], []).append(d["token"])

            futs.append(eng.submit(clip, on_token=on_token))
            streamed.append(by_window)
            time.sleep(float(gap))
        out["results"] = [f.result(timeout=600) for f in futs]
        out["streamed"] = streamed
        eng.close()
        require(not eng._thread.is_alive(), "the mesh engine's thread stopped")
    torch.cuda.synchronize()
    out.update(wall=time.time() - t0, launches=read_counts(torch),
               stats=eng.stats())
    return out


ENGINE_MESH_STATS = ("joins", "installs", "steps", "chunks", "fast_chunks",
                     "long_chunks", "spec_rounds", "spec_emitted",
                     "spec_slot_rounds")


def engine_mesh_cases(torch, cfg, tok, fresh, cases, clips, gaps,
                      out) -> dict:
    """The in-flight engine over a mesh, once for each (name, data, model,
    engine keywords) of ``cases``: ``fresh()`` parameters, bf16, the int8
    cross cache, PARALLEL_SLOTS slots, PARALLEL_MAX_NEW tokens a window,
    TP-sharded where model > 1, on the stream ``clips`` at ``gaps``
    (``parallel_mesh_run``). Records in ``out`` each case's launches
    ("paths"), their prediction from the rank's installs and steps ("want":
    K1 once an installed window, K2 once an encoder layer of one, K4 once
    a decoder layer a single-query step), wall, stats, local shapes and,
    on rank 0, the steps it asked for ("asked"). Returns the runs by
    name."""
    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher

    runs = {}
    for key in ("paths", "want", "walls", "stats", "shapes", "asked"):
        out.setdefault(key, {})
    for name, data, model, extra in cases:
        eng = ContinuousBatcher(
            fresh(), cfg, mesh=make_mesh(data=data, model=model),
            tensor_parallel=model > 1, slots=PARALLEL_SLOTS,
            max_new_tokens=PARALLEL_MAX_NEW, bf16=True, kv_int8=True,
            tokenizer=tok, **extra)
        out["shapes"][name] = dict(
            self_k=list(eng.cache.self_k.shape),
            K2=[cfg.n_audio_head // model, 1500, 64],
            K4=[PARALLEL_SLOTS // data, cfg.n_text_head // model, 1, 64])
        run = parallel_mesh_run(torch, eng, clips, gaps)
        st = run["stats"]
        out["want"][name] = {"K1": st["installs"],
                             "K2": cfg.n_audio_layer * st["installs"],
                             "K4": cfg.n_text_layer * st["steps"]}
        out["paths"][name] = run["launches"]
        out["walls"][name] = run["wall"]
        out["stats"][name] = {k: st[k] for k in ENGINE_MESH_STATS}
        if eng._leader:  # the one rank that counts its chunks by kind
            plain = st["chunks"] - st["fast_chunks"] - st["long_chunks"]
            out["asked"][name] = (st["fast_chunks"]
                                  + plain * eng.steps_per_sync
                                  + st["long_chunks"] * eng.adaptive_rounds)
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    return runs


def engine_mesh_agree(torch, dev, cfg, tok, fresh, clips, gaps, runs):
    """Rank 0, after ``engine_mesh_cases``: the engine alone on its card
    on the same stream (``runs["engine one rank"]``), then decode() of
    every window with the one-rank parameters, and every run's tokens held
    to it under the near-tie rule. Returns (agreement by run: windows,
    equal, near-ties, gaps, tokens, wall, tokens a second; eps; the oracle
    and its mels by (request, window); ``hold(name, rows)``, which holds
    more rows to decode() alike)."""
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher

    full = fresh()
    eng = ContinuousBatcher(full, cfg, device=dev, slots=PARALLEL_SLOTS,
                            max_new_tokens=PARALLEL_MAX_NEW, bf16=True,
                            kv_int8=True, tokenizer=tok)
    try:
        runs["engine one rank"] = run_engine(torch, dev, eng, clips, gaps)
    finally:
        eng.close()
    oracle, mels = engine_oracle(torch, dev, cfg, full, tok, clips, bf16=True)
    oracle = {k: v[:PARALLEL_MAX_NEW] for k, v in oracle.items()}
    eps = 2 * step0_delta(torch, cfg, full, list(mels.values()), eng.prefix)

    def hold(name, rows):
        return hold_to_decode(torch, cfg, full, tok, rows, eng.prefix,
                              eng.suppress, eng.blank, eng.dtype, eps, name)

    agree = {}
    for name, run in runs.items():
        rows = [(f"request {i} window {w}", run["streamed"][i].get(w, []), want,
                 mels[(i, w)], False) for (i, w), want in oracle.items()]
        equal, near, at = hold(name, rows)
        emitted = sum(len(r["tokens"]) for r in run["results"])
        agree[name] = dict(windows=len(rows), equal=equal, near_ties=near,
                           gaps=at, tokens=emitted, wall=run["wall"],
                           tokens_per_s=emitted / run["wall"])
    return agree, eps, oracle, mels, hold


def parallel_engine_paths(torch, rank: int, dev, cfg, tok, fresh, out) -> None:
    """The in-flight engine and the service's speculation over two ranks
    on the card (gloo), at whisper-small, bf16, the int8 cross cache, 8
    slots, 24 tokens a window, on a seeded stream of 6 requests (5-40 s,
    two windows past 30 s) 20-60 ms apart (``engine_mesh_cases``): (a) the
    engine at TP=2, then at TP=2 with adaptive sync (long chunks of
    PARALLEL_ADAPTIVE_MULT * 4 steps, each of which the all-halted check
    stops early), (b) at DP=2 (4 slots a rank), (c) at TP=2 with
    DEFAULT_TREE on untrained heads; (d) the micro-batch service at TP=2
    with a whisper-tiny draft (seed 1, replicated), its first 4 requests
    in one batch. Rank 0 also runs the engine alone on the same stream
    (tokens a second against the mesh runs) and holds every run's tokens
    to decode() on the one-rank parameters under the near-tie rule
    (``engine_mesh_agree``). Each rank's launches are held to the
    prediction from its own installs, steps and batches."""
    import torch.distributed as dist

    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.medusa import init_medusa_params
    from whisper_ipa_torch.parallel import make_mesh
    from whisper_ipa_torch.serve import TranscriptionService

    clips, gaps = engine_stream(PARALLEL_REQUESTS, seed=70)
    runs = engine_mesh_cases(torch, cfg, tok, fresh, (
        ("engine tp2", 1, 2, {}),
        ("engine tp2 adaptive", 1, 2, dict(
            adaptive_sync=True, adaptive_mult=PARALLEL_ADAPTIVE_MULT)),
        ("engine dp2", 2, 1, {}),
        ("engine tp2 medusa tree", 1, 2, dict(
            medusa_params=init_medusa_params(cfg, SPEC_K, seed=0, device=dev),
            medusa_tree=DEFAULT_TREE)),
    ), clips, gaps, out)

    # (d) the service's draft-model speculation at TP=2, on the first
    # window of the stream's first requests (one batch)
    svc_clips = [c[:SAMPLE_RATE * 30] for c in clips[:PARALLEL_SVC_BATCH]]
    mesh = make_mesh(model=2)
    tiny = CONFIGS["tiny"]
    svc = TranscriptionService(
        fresh(), cfg, device=dev, batch_size=PARALLEL_SVC_BATCH,
        max_wait_ms=2000, mesh=mesh, tensor_parallel=True,
        draft_params=init_params(tiny, seed=1, device=dev), draft_cfg=tiny,
        draft_k=SPEC_K, tokenizer=tok)
    svc.options = replace(svc.options, sample_len=PARALLEL_MAX_NEW)
    decoded = []
    rows = svc._decode_rows

    def spy(audio):  # the rows' DecodingResults, for their tokens
        res = rows(audio)
        decoded.extend(r.tokens for r in res)
        return res

    svc._decode_rows = spy
    reset_counts(torch)
    t0 = time.time()
    if svc._thread is None:
        svc.follow()
    else:
        futs = [svc.submit(c) for c in svc_clips]
        for f in futs:
            f.result(timeout=600)
        svc.close()
    torch.cuda.synchronize()
    name = "service tp2 draft"
    batches = 1
    out["paths"][name] = read_counts(torch)
    out["walls"][name] = time.time() - t0
    out["want"][name] = {"K1": batches, "K2": (cfg.n_audio_layer
                                               + tiny.n_audio_layer) * batches}
    out["shapes"][name] = dict(K2=[PARALLEL_SVC_BATCH * cfg.n_audio_head // 2,
                                   1500, 64])
    require(len(decoded) == PARALLEL_SVC_BATCH * batches,
            f"rank {rank}: the service decoded {len(decoded)} rows")
    out["service_tokens"] = decoded[:PARALLEL_SVC_BATCH]
    del svc
    torch.cuda.empty_cache()

    if rank == 0:
        agree, out["eps"], oracle, mels, hold = engine_mesh_agree(
            torch, dev, cfg, tok, fresh, clips, gaps, runs)
        # the service's rows against decode() of their windows
        rows = [(f"service request {i}", out["service_tokens"][i],
                 oracle[(i, 0)], mels[(i, 0)], False)
                for i in range(PARALLEL_SVC_BATCH)]
        equal, near, at = hold(name, rows)
        agree[name] = dict(windows=len(rows), equal=equal, near_ties=near,
                           gaps=at)
        out["agree"] = agree
        del hold
        torch.cuda.empty_cache()
    dist.barrier()


def parallel_rank(rank: int, port: int, out_dir: str) -> None:
    """A spawned rank: joins the gloo group on the card, runs its body and
    writes its result; any error exits non-zero."""
    import torch
    import torch.distributed as dist

    from whisper_ipa_torch.parallel import initialize

    initialize(f"localhost:{port}", 2, rank, device="cuda:0", backend="gloo")
    try:
        result = parallel_rank_body(torch, rank)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(torch, dev, by_path) -> None:
    """whisper_ipa_torch.parallel on the card: (a) a one-rank NCCL group,
    (b) two ranks sharing the card over gloo (spawned after every kernel
    was built, so no rank builds): TP=2 greedy decoding at the serving
    setting (tokens held to the one-rank run under the near-tie rule),
    decoder-only DP=2, ZeRO-1 and FSDP steps at global batch 12 (a chunk
    of PARALLEL_STEPS, its rows cut by shard_chunk), and a
    TP=2 full fine-tune step (K5 on 6 local heads), each against the
    one-rank run: losses within 2e-3 relative, parameters within a mean
    10% of the one-rank run's mean update (bf16 activations); then the
    engine and the service's speculation over the two ranks
    (``parallel_engine_paths``), every window held to decode() under the
    near-tie rule, the service's two TP ranks decoding equal tokens, each
    window installed on the ranks that own its slot."""
    import multiprocessing as mp

    t_phase = time.time()
    parallel_nccl_one_rank(torch, dev)
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")  # CUDA cannot fork
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    port = free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, port, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + PARALLEL_TIMEOUT
    try:
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            require(not bad, f"a parallel rank failed (exit codes {bad})")
            require(time.time() < deadline, "the parallel ranks timed out")
            time.sleep(0.5)
        require(all(p.exitcode == 0 for p in procs),
                f"parallel ranks exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(out_dir, ignore_errors=True)

    layers = 12
    want = {
        "tp2 decode": {"K1": 1, "K2": layers, "K4": (MAIN_SAMPLE_LEN - 1) * layers},
        "dp dp2 train": {"K2": layers * PARALLEL_STEPS},
        "zero1 dp2 train": {"K2": layers * PARALLEL_STEPS},
        "fsdp dp2 train": {"K2": layers * PARALLEL_STEPS},
        "tp2 full fine-tune": {"K2": layers, "K5": layers},
    }
    for r in ranks:
        log(f"[parallel rank {r['rank']}] local-shape kernel checks "
            f"(max|kernel-plain|; K5 relative): "
            + ", ".join(f"{k} {v:.3e}" for k, v in r["checks"].items()))
        for path, counts in r["paths"].items():
            got = nonzero(counts)
            # the engine and service paths: from the rank's own installs,
            # steps and batches
            pred = nonzero(r["want"].get(path, want.get(path, {})))
            require(got == pred, f"rank {r['rank']} {path}: launches "
                    f"{got}, predicted {pred}")
            by_path[f"parallel rank{r['rank']} {path}"] = counts
            log(f"[parallel rank {r['rank']}] {path}: launches {got}, local "
                f"shapes {r['shapes'][path]}, wall {r['walls'][path]:.2f} s"
                + (f", stats {r['stats'][path]}" if path in r["stats"] else ""))
        log(f"[parallel rank {r['rank']}] staged through host memory (gloo "
            f"with CUDA tensors): {r['staged']}")
    r0 = ranks[0]
    d = r0["decode"]
    log(f"[parallel] tp2 decode (whisper-small, bf16, int8 cache, batch "
        f"{MAIN_BATCH} x 30 s, {MAIN_SAMPLE_LEN} tokens): {d['rows_equal']} of "
        f"{MAIN_BATCH} rows equal to the one-rank run's, {d['near_ties']} "
        f"left it at a near-tie (gaps {d['gaps']}, eps {d['eps']:.3e})")
    for path in ("dp dp2 train", "zero1 dp2 train", "fsdp dp2 train",
                 "tp2 full fine-tune"):
        res = r0[path]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                       res["ref_losses"]))
        log(f"[parallel] {path}: losses {res['losses']} vs one rank "
            f"{res['ref_losses']} (max relative {rel:.2e}, bound 2e-3); "
            f"parameters max|diff| {res['max_diff']:.3e}, mean|diff| "
            f"{res['mean_diff']:.3e} against a mean update of "
            f"{res['mean_update']:.3e} (bound 10%)")
        require(rel <= 2e-3, f"{path} losses")
        require(res["mean_diff"] <= 0.1 * res["mean_update"], f"{path} parameters")
    base = r0["dp dp2 train"]["losses"]
    for path in ("zero1 dp2 train", "fsdp dp2 train"):
        require(max(abs(a - b) / abs(b) for a, b in
                    zip(r0[path]["losses"], base)) <= 1e-6,
                f"{path}: the DP run's losses")
    one = r0["agree"]["engine one rank"]
    for path, a in r0["agree"].items():
        rate = ""
        if "tokens_per_s" in a:
            rate = (f"; {a['tokens']} tokens in {a['wall']:.2f} s, "
                    f"{a['tokens_per_s']:.1f} tokens/s "
                    f"({a['tokens_per_s'] / one['tokens_per_s']:.3f}x one rank)")
        log(f"[parallel] {path} (whisper-small, bf16, int8 cache, "
            f"{PARALLEL_MAX_NEW} tokens): {a['equal']} of {a['windows']} "
            f"windows equal decode()'s, {a['near_ties']} left it at a "
            f"near-tie (gaps {a['gaps']}, eps {r0['eps']:.3e}){rate}")
    require(ranks[0]["service_tokens"] == ranks[1]["service_tokens"],
            "service tp2 draft: both TP ranks decode the same tokens")
    # the adaptive TP run: both TP ranks stop each long chunk at the same
    # step, before the rounds rank 0 asked for
    path = "engine tp2 adaptive"
    st = [r["stats"][path] for r in ranks]
    asked = r0["asked"][path]
    log(f"[parallel] {path}: {st[0]['long_chunks']} long chunks, steps run "
        f"{[s['steps'] for s in st]} by rank of {asked} asked")
    require(st[0]["long_chunks"] > 0 and st[0]["steps"] == st[1]["steps"]
            < asked, f"{path}: long chunks stopped early on both ranks alike")
    for path in ("engine tp2", "engine tp2 adaptive", "engine dp2",
                 "engine tp2 medusa tree"):
        st = [r["stats"][path] for r in ranks]
        require(all(s["installs"] for s in st) and sum(
            s["installs"] for s in st) == (1 if "dp2" in path else 2)
            * st[0]["joins"], f"{path}: each window installed on the ranks "
            "that own its slot")
    log(f"[phase_parallel] phase wall {time.time() - t_phase:.1f} s")


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
    native = build_native()
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
    phase_build(native)

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
    for phase in (phase_timestamps, phase_beam, phase_transcribe):
        t0 = time.time()
        phase(torch, dev, cfg, params, tok, by_path)
        log(f"[{phase.__name__}] phase wall {time.time() - t0:.1f} s")
    phase_parity(torch, dev, tok)
    phase_service(torch, dev, cfg, params, tok)
    phase_service(torch, dev, cfg, params, tok, quant_bits=4, kv_int4=True)
    stream = phase_engine(torch, dev, cfg, params, tok, by_path)
    cut = phase_engine_speculative(torch, dev, cfg, params, tok, by_path,
                                   stream)
    del stream
    cut["speculative unrelated draft"] = round(phase_speculative(
        torch, dev, cfg, params, tok, by_path, card), 1)
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
    added_s = trained["decoder-only chunked"]["added_s"] + phase_kernel_ab(
        torch, dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        phase_prep(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_learn_")
    try:
        learned = phase_learn(torch, dev, root, by_path)
        phase_speculative_learned(torch, dev, root, learned, by_path)
        phase_zeroshot(torch, dev, root, learned, by_path)
        phase_tools(torch, dev, learned, by_path)
        phase_examples(torch, dev, root, learned, by_path)
        del learned
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_parallel(torch, dev, by_path)
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s; of it "
        f"the chunked training run, the sync checks and the kernel A/B took "
        f"{added_s:.1f} s, and the draft-model runs at their cut depth "
        f"{sum(cut.values()):.1f} s ({cut})")

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
