#!/usr/bin/env python3
"""Time K9, the PyTorch port's stochastic int8 weight quantization, on one
CUDA card, through the checkout at ``--root``: ``quantize_params_device``
on whisper-small's tree (random weights from seed 0, 192 block weights)
and one (768, 3072) f32 weight through ``stochastic_quantize_int8``.

    python3 perf/torch_sr_quant_tree.py --root <checkout> [--label NAME]

To compare two checkouts, run it on each in turn in one machine (parent,
change, change, parent). Each timing is one JSON line: device ms and
kernels a call from torch.profiler (``chip_smoke.device_profile`` of this
script's repository: 10 tree calls, 50 weight calls a window), CUDA-event
ms a call, and, for the tree, the host-clock walls of ten synchronised
calls.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def smoke_helpers():
    """chip_smoke.py of this script's repository, as a module (its
    profiling and timing helpers)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout to import from")
    ap.add_argument("--label", default="", help="name printed on each line")
    args = ap.parse_args()
    smoke = smoke_helpers()
    sys.path.insert(0, args.root)

    import torch

    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.ops import sr_quant as sr

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    params = init_params(CONFIGS["small"], seed=0, device=dev)
    tree = lambda: sr.quantize_params_device(params)  # noqa: E731
    tree()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.time()
        tree()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    dev_ms, kernels = smoke.device_profile(torch, tree, iters=10)
    print(json.dumps(dict(label=args.label, call="tree", device_ms=dev_ms,
                          kernels=kernels,
                          events_ms=smoke.cuda_ms(tree, iters=10),
                          walls_s=walls)), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    w = 0.05 * torch.randn((768, 3072), generator=gen, device=dev)
    one = lambda: sr.stochastic_quantize_int8(w, seed=7)  # noqa: E731
    dev_ms, kernels = smoke.device_profile(torch, one, iters=50)
    print(json.dumps(dict(label=args.label, call="weight (768, 3072)",
                          device_ms=dev_ms, kernels=kernels,
                          events_ms=smoke.cuda_ms(one, iters=50))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
