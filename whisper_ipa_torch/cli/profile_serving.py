"""CLI: where the serving path's time goes, on one CUDA card.

Drives waveform -> log-mel -> encoder -> greedy decode (or beam search
with ``--beam-size``; the timestamp grammar with ``--timestamps``) at a
model's full width with random weights from seed 0, in any of the serving
variants (weight bits, cross-cache type, the fused cache build, int8
activations), and prints:
  - host-clock walls (device synchronised) of the whole run and its stages:
    log-mel + encoder, cache build + prefix step (a sample_len=1 decode from
    the encoder output), and the token loop;
  - from one run under ``torch.profiler``: device time summed over kernels,
    its share of that run's wall, the port's kernels (K1-K10) each with its
    device time and kernel launches, and the kernels that take the most,
    with their launch counts;
and, as its last line, the same as one JSON object.

    python -m whisper_ipa_torch.cli.profile_serving --quant-bits 4 --kv int4
    python -m whisper_ipa_torch.cli.profile_serving --batch 4 --beam-size 5
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace

import numpy as np
import torch


# the port's hand-written kernels by the names of their device functions
PORT_KERNELS = {
    "K1": ("log_mel_fft_kernel",),
    "K2/K10": ("attention_fwd_",),
    "K3": ("kv_init_tma", "kv_init_f32"),
    "K4": ("decode_int8_cluster_kernel",),
    "K5": ("attn_bwd_",),
    "K6": ("int8_gemm_", "quantize_rows_kernel"),
    "K7": ("int4_matmul_",),
    "K8": ("decode_int4_cluster_kernel",),
    "K9": ("sr_quant_kernel",),
}


def port_kernel_times(kernels) -> dict:
    """{K: {"device_ms", "launches"}} summed over the profiler's kernel
    events whose names carry one of the kernel's device functions; a K with
    several device functions (K6's row pass and product) counts each."""
    out = {}
    for e in kernels:
        for k, names in PORT_KERNELS.items():
            if any(n in e.key for n in names):
                t = out.setdefault(k, {"device_ms": 0.0, "launches": 0})
                t["device_ms"] += e.self_device_time_total / 1e3
                t["launches"] += e.count
                break
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile the port's serving path")
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sample-len", type=int, default=64)
    p.add_argument("--quant-bits", type=int, choices=(8, 4), default=None)
    p.add_argument("--kv", choices=("float", "int8", "int4"), default="int8")
    p.add_argument("--fused-kv-init", action="store_true")
    p.add_argument("--int8-activations", action="store_true")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--timestamps", action="store_true",
                   help="decode with the timestamp grammar")
    return p


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving needs a CUDA device", file=sys.stderr)
        return 2
    from ..config import CONFIGS
    from ..decode import DecodingOptions, decode
    from ..models import (encode, init_params, params_to, use_fused_kv_init,
                          use_int8_activations)
    from ..ops import log_mel_spectrogram
    from ..ops.quant import quantize_params
    from ..tokenizer import get_tokenizer

    dev = torch.device("cuda", 0)
    cfg = CONFIGS[args.model]
    params = init_params(cfg, seed=0)
    if args.quant_bits:
        params = quantize_params(params, bits=args.quant_bits)
    params = params_to(params, dev)
    use_fused_kv_init(args.fused_kv_init)
    use_int8_activations(args.int8_activations)
    tok = get_tokenizer(multilingual=cfg.multilingual,
                        num_languages=cfg.num_languages, language="en")
    options = DecodingOptions(
        language="en", without_timestamps=not args.timestamps,
        sample_len=args.sample_len, beam_size=args.beam_size,
        suppress_tokens=[-1, tok.eot],  # every row decodes sample_len tokens
        fp16=True, kv_int8=args.kv == "int8", kv_int4=args.kv == "int4",
    )
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(
        (rng.standard_normal((args.batch, 30 * 16000)) * 0.1).astype(np.float32)
    ).to(dev)

    def features():
        with torch.inference_mode():
            mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
            return encode(params, cfg, mel, dtype=torch.bfloat16)

    def run():
        with torch.inference_mode():
            mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
        return decode(params, cfg, mel, options, tokenizer=tok)

    run()  # warm-up
    _, wall = _synced(run)
    feats, t_encode = _synced(features)
    _, t_prefix = _synced(lambda: decode(params, cfg, feats,
                                         replace(options, sample_len=1),
                                         tokenizer=tok))
    _, t_decode = _synced(lambda: decode(params, cfg, feats, options,
                                         tokenizer=tok))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = _synced(run)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    steps = max(args.sample_len - 1, 1)

    result = {
        "device": torch.cuda.get_device_name(0),
        "variant": vars(args),
        "wall_s": wall,
        "encode_s": t_encode,
        "cache_and_prefix_s": t_prefix,
        "loop_s_per_step": (t_decode - t_prefix) / steps,
        "profiled_wall_s": prof_wall,
        "device_kernel_s": device_s,
        "device_busy_share": device_s / prof_wall,
        "port_kernels": port_kernel_times(kernels),
        "top_kernels": [
            {"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in kernels[:12]
        ],
    }
    print(f"[profile] {result['device']} {result['variant']}")
    print(f"  wall {wall:.4f} s: log-mel + encoder {t_encode:.4f} s, cache + "
          f"prefix {t_prefix:.4f} s, loop {result['loop_s_per_step'] * 1e3:.3f} "
          f"ms a step; profiled run {prof_wall:.4f} s, kernels {device_s:.4f} s "
          f"on the device (busy {result['device_busy_share']:.1%})")
    for k, t in result["port_kernels"].items():
        print(f"  {k}: {t['device_ms']:.3f} ms of device time, {t['launches']} "
              f"kernel launches")
    for k in result["top_kernels"]:
        print(f"  {k['device_ms']:10.3f} ms {k['calls']:7d} x  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
