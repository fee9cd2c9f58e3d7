#!/usr/bin/env python3
"""Time K8, the PyTorch port's int4 single-query cross-attention, on one
CUDA card, through the checkout at ``--root``: at batch 1, 4 and 16 (B*H
12, 48, 192 at whisper-small's 12 heads), T_pad 1536 (1500 positions),
Dh 64, bf16 q, through its wrapper, and, where that checkout has
``ops.decode_attention.launch_cluster``, at every split of T from 1 to 8.

    python3 perf/torch_decode_int4_sweep.py --root <checkout> [--label NAME]

To compare two checkouts, run it on each in turn in one machine (parent,
change, change, parent). Each timing is one JSON line: device ms and
kernels a call from torch.profiler over 50 calls, CUDA-event ms a call,
and the wrapper's max|kernel - plain| / max|plain|.
"""

from __future__ import annotations

import argparse
import json
import sys


def device_profile(torch, fn, iters: int = 50):
    """(device ms, kernels) of one fn() call under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return (sum(e.self_device_time_total for e in events) / iters / 1e3,
                    sum(e.count for e in events) / iters)
    raise RuntimeError("torch.profiler recorded no device kernel")


def events_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout to import from")
    ap.add_argument("--label", default="", help="name printed on each line")
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from whisper_ipa_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, Dh, T, T_pad = 16, 12, 64, 1500, 1536

    def packed():
        c = torch.randint(-128, 128, (B, H, Dh, T_pad // 2), generator=gen,
                          device=dev)
        return c.to(torch.int8).contiguous()

    def scales():
        s = 0.1 + 0.2 * torch.rand((B, H, T_pad), generator=gen, device=dev)
        s[..., T:] = 0.0
        return s.contiguous()

    k, ks, v, vs = packed(), scales(), packed(), scales()
    q = (torch.randn((B, H, 1, Dh), generator=gen, device=dev)
         * Dh ** -0.5).to(torch.bfloat16)
    for b in (1, 4, 16):
        ops = (q[:b], k[:b], ks[:b], v[:b], vs[:b])
        got = da.decode_cross_attention_int4_tminor(*ops)
        want = da.decode_attention_int4_plain(*ops)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        calls = [("wrapper", None, lambda ops=ops:
                  da.decode_cross_attention_int4_tminor(*ops))]
        if hasattr(da, "launch_cluster"):
            for splits in range(1, 9):
                slice_t = -(-T_pad // (32 * splits)) * 32
                calls.append((
                    "split", (-(-T_pad // slice_t), slice_t),
                    lambda ops=ops, s=splits, n=slice_t:
                        da.launch_cluster("int4", *ops, s, n)))
        for what, split, fn in calls:
            dev_ms, kernels = device_profile(torch, fn)
            print(json.dumps(dict(
                label=args.label, bh=b * H, t_pad=T_pad, call=what,
                split=split, device_ms=dev_ms, kernels=kernels,
                events_ms=events_ms(torch, fn),
                rel_err=err if what == "wrapper" else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
