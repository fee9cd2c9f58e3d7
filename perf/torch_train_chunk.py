#!/usr/bin/env python3
"""Time the PyTorch port's training loop on one CUDA card, one step a call
against chunks: ``train()`` of the checkout at ``--root`` at whisper-small
(random init, seed 0), decoder-only, bf16 activations, batch 12, for
``--steps`` steps with ``--steps-per-call`` C, on a seeded set of
synthesized utterances (``chip_smoke.write_train_set``, the mel cache
filled first, so the loader reads cached mels).

    python3 perf/torch_train_chunk.py --root <checkout> --steps-per-call 8 \\
        [--data <dir>] [--label NAME]

Prints one JSON line: the logged step times (a chunk's wall over its
steps, the device waited for), their median from step 20 on, the mean
step wall between the logs of steps 20 and 40 (the CSV's wall-clock
column; the chunk that holds step 20 ends at the next multiple of C), and
from the loop's own ``torch.profiler`` trace of steps 10-15
(``train(profile_dir=)``) the window's wall, the device's kernel time and
its busy share (the union of kernel intervals over the window). Under C = 8 the window's steps run as
chunks of 4 and 2: the profiler's marks at steps 9 and 15 bound chunks.
To compare two checkouts, run each in its own process in turns (parent,
change, change, parent) in one machine; a checkout whose ``train()``
refuses C > 1 prints its error instead.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_share(trace_path: str) -> dict:
    """Window wall, kernel time and busy share of a chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    union, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    return dict(window_ms=(end - start) / 1e3,
                kernel_ms=sum(e - s for s, e in kernels) / 1e3,
                kernels=len(kernels), busy=union / (end - start))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout to import from")
    ap.add_argument("--steps-per-call", type=int, default=1)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--utterances", type=int, default=48)
    ap.add_argument("--data", default=None,
                    help="directory of the synthesized set (made if "
                         "missing; default <root>/artifacts/train_chunk_set, "
                         "one set and mel cache a checkout)")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_chunk needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import write_train_set

    sys.path.insert(0, args.root)
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.train import train

    dev = torch.device("cuda", 0)
    if args.data is None:
        args.data = os.path.join(os.path.abspath(args.root), "artifacts",
                                 "train_chunk_set")
    mels = os.path.join(args.data, "mels")
    path = os.path.join(args.data, "train.json")
    if not os.path.isfile(path):
        path = write_train_set(args.data, args.utterances, seed=0)
        create_data_loader(path, n_mels=80,
                           mel_cache_dir=mels).precompute_mels(dev)
    out = tempfile.mkdtemp(prefix="train_chunk_")
    profile = os.path.join(out, "profile")
    line = dict(label=args.label, root=args.root,
                steps_per_call=args.steps_per_call,
                card=torch.cuda.get_device_name(0))
    try:
        t0 = time.time()
        train(model_name="small", train_data_path=path, test_data_path=path,
              output_dir=out, num_steps=args.steps, batch_size=args.batch,
              learning_rate=1e-5, validate_every=0, save_every=0,
              mel_cache_dir=mels, compute_dtype="bfloat16",
              freeze_encoder=True, final_validate=False, profile_dir=profile,
              steps_per_call=args.steps_per_call, device="cuda")
        line["wall_s"] = time.time() - t0
        with open(os.path.join(out, "training_log.csv"), newline="") as f:
            log = list(csv.DictReader(f))
        rows = {int(r["step"]): float(r["step_time_sec"]) for r in log}
        elapsed = {int(r["step"]): float(r["wall_clock_sec"]) for r in log}
        line["step_s"] = rows
        line["steady_step_s"] = statistics.median(
            t for s, t in rows.items() if s >= 20)
        c = args.steps_per_call
        end20 = -(-20 // c) * c
        line["mean_step_s"] = ((elapsed[args.steps] - elapsed[20])
                               / (args.steps - end20))
        line.update(busy_share(os.path.join(profile, "trace.json")))
    except Exception as e:  # a checkout that refuses C > 1
        line["error"] = f"{type(e).__name__}: {e}"
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
