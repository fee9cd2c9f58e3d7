"""CLI: end-to-end A/B of weight-quantized greedy decoding.

Counterpart of ``whisper_ipa_tpu/cli/bench_quant_decode.py``. Times
``decode()`` at serving shapes (whisper-small from ``init_params(seed=0)``,
batch 16, ``--sample-len`` tokens forced by suppressing EOT, bf16
activations, float cross cache) across weight formats: f32; int8
weight-only (``models.layers.linear`` dequantizes a bf16 copy of each
weight on every call); int4 on the half-weight path
(``use_int4_matmul(False)``); and int4 through K7 (``int4-kernel``). The
log-mel of seeded noise (K1 on the card) is computed once. Each mode
prints its best of ``--repeats`` decodes (host clock: ``decode()`` returns
host tokens, so it has waited for the device) as ms a decode and ms a
token, and its first call's seconds (kernel builds included). The
``int4-kernel`` mode needs CUDA.

  python -m whisper_ipa_torch.cli.bench_quant_decode --batch 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import add_device_flag

MODES = ("f32", "int8", "int4", "int4-kernel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="A/B of weight-quantized greedy decoding"
    )
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sample-len", type=int, default=32)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--modes", default=",".join(MODES),
        help="comma list of f32,int8,int4,int4-kernel",
    )
    add_device_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    modes = args.modes.split(",")
    for mode in modes:
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "bench_quant_decode: --device cuda needs CUDA "
            "(torch.cuda.is_available() is false); --device cpu runs the "
            "plain modes"
        )
    if dev.type != "cuda" and "int4-kernel" in modes:
        raise SystemExit("bench_quant_decode: int4-kernel (K7) needs CUDA")

    from ..audio import N_SAMPLES
    from ..config import get_config
    from ..decode import DecodingOptions, decode
    from ..models import init_params, layers, params_to
    from ..ops import log_mel_spectrogram
    from ..ops.quant import quantize_params
    from ..tokenizer import get_tokenizer

    cfg = get_config(args.model)
    params = init_params(cfg, seed=0)
    tokenizer = get_tokenizer(
        multilingual=True, num_languages=cfg.num_languages, language="en"
    )
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        rng.standard_normal((args.batch, N_SAMPLES)).astype(np.float32) * 0.1
    ).to(dev)
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    options = DecodingOptions(
        language="en", without_timestamps=True,
        sample_len=args.sample_len,
        suppress_tokens=[-1, tokenizer.eot],  # full-length decode
        fp16=True,
    )
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {card}; {cfg.name}, batch {args.batch}, "
          f"{args.sample_len} tokens, bf16")

    results, host = {}, {}
    for name in modes:
        bits = {"int8": 8, "int4": 4, "int4-kernel": 4}.get(name)
        if bits and bits not in host:  # int4 and int4-kernel share theirs
            host[bits] = quantize_params(params, bits=bits)
        pp = params_to(host[bits] if bits else params, dev)
        layers.use_int4_matmul(name == "int4-kernel")
        try:
            t0 = time.time()
            decode(pp, cfg, mel, options, tokenizer=tokenizer)
            first_s = time.time() - t0
            best = float("inf")
            for _ in range(args.repeats):
                t0 = time.time()
                decode(pp, cfg, mel, options, tokenizer=tokenizer)
                best = min(best, time.time() - t0)
        finally:
            layers.use_int4_matmul(True)
        del pp
        results[name] = best
        print(
            f"{name:12s} {best * 1000:7.1f} ms/decode "
            f"({best / args.sample_len * 1000:6.2f} ms/token, "
            f"first call {first_s:.1f} s)"
        )
    return results


if __name__ == "__main__":
    main()
