"""CLI: A/B of the decode cross-attention's two paths on the quantized
T-minor cross cache, in isolation.

Counterpart of ``whisper_ipa_tpu/cli/bench_decode_kernel.py``. A chain of
``--steps`` single-query steps, each through ``--layers`` layers of
``models.layers.multi_head_attention_int8kv`` (whisper-small's shapes by
default), runs on codes and scales made on the device from a seeded
generator, once with ``use_decode_kernel(False)`` (the plain path:
dequantize, then the products) and once through the kernel: K4 on the
int8 cache, K8 on the nibble-packed int4 cache (``--int4``). Each arm's
best of ``--repeats`` runs is timed with CUDA events after a warm-up and
printed as ms a token and effective GB/s (K and V codes plus their f32
scales, each read once a layer and step), then which arm wins.
``--device cpu`` runs the plain arm alone (host clock); the kernel arm
needs CUDA.

  python -m whisper_ipa_torch.cli.bench_decode_kernel --batch 128
  python -m whisper_ipa_torch.cli.bench_decode_kernel --batch 16 --int4
"""

from __future__ import annotations

import argparse
import time

import torch

from . import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="A/B of the decode cross-attention: plain vs K4 (K8)"
    )
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--t", type=int, default=1536)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--int4", action="store_true",
        help="bench the nibble-packed int4 cache paths instead of int8",
    )
    add_device_flag(p)
    return p


def make_data(L, B, H, Dh, T, int4, device, seed: int = 0):
    """(codes K, scales K, codes V, scales V), each with a leading layer
    axis: int8 codes in [-127, 127] ((L, B, H, Dh, T), or T/2 packed bytes
    under int4) and scales uniform in [0.001, 0.02), drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = (L, B, H, Dh, T // 2 if int4 else T)

    def codes():
        return torch.randint(-127, 128, shape, generator=g, device=device,
                             dtype=torch.int32).to(torch.int8)

    def scales():
        return 0.001 + 0.019 * torch.rand((L, B, H, T), generator=g,
                                          device=device)

    return codes(), scales(), codes(), scales()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..models import layers

    kernel = "K8" if args.int4 else "K4"
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit(
            f"bench_decode_kernel: the {kernel} arm needs CUDA "
            "(torch.cuda.is_available() is false); --device cpu runs the "
            "plain arm alone"
        )
    L, B, H, Dh, T = args.layers, args.batch, args.heads, args.head_dim, args.t
    print(f"device: {torch.cuda.get_device_name(dev) if cuda else 'cpu'}; "
          f"L {L}, B {B}, H {H}, Dh {Dh}, T {T}, "
          f"{'int4' if args.int4 else 'int8'} cache")
    data = make_data(L, B, H, Dh, T, args.int4, dev)

    def run():
        q = torch.ones((B, 1, H * Dh), dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            for _ in range(args.steps):
                for k, ks, v, vs in zip(*data):
                    q = layers.multi_head_attention_int8kv(
                        q, k, ks, v, vs, H).to(q.dtype)
        return q.float().sum()

    def timed() -> float:
        """Seconds of one run: CUDA events on the card, else host clock."""
        if not cuda:
            t0 = time.perf_counter()
            run()
            return time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3

    # K+V codes + f32 scales, each streamed once per (layer, step)
    code_bytes = Dh // 2 if args.int4 else Dh
    bytes_per_step = L * B * H * T * (2 * code_bytes + 2 * 4)
    results = {}
    arms = (("plain", False), (kernel, True)) if cuda else (("plain", False),)
    try:
        for name, flag in arms:
            layers.use_decode_kernel(flag)
            timed()  # warm
            best = min(timed() for _ in range(args.repeats))
            ms_tok = best / args.steps * 1000
            gbs = bytes_per_step / (best / args.steps) / 1e9
            results[name] = ms_tok
            print(
                f"{name:14s} {ms_tok:7.2f} ms/token   {gbs:6.0f} GB/s "
                f"effective   (total {best:.3f} s / {args.steps} steps)"
            )
    finally:
        layers.use_decode_kernel(True)
    if kernel in results:
        if results[kernel] < results["plain"]:
            print(f"kernel wins: {results['plain'] / results[kernel]:.2f}x")
        else:
            print(f"plain wins: {results[kernel] / results['plain']:.2f}x")
    return results


if __name__ == "__main__":
    main()
