"""Profile the inference (or train) hot path under ``torch.profiler`` and
print a per-op time table.

The reference has no profiler tooling at all (its speed story is the
out-of-process monitor, reference calculate_real_speed.py). Counterpart of
``whisper_ipa_tpu/cli/profile_inference.py``, whose ``jax.profiler.trace``
and xplane digest become one ``torch.profiler`` run: after a warm-up, one
profiled execution of

  decode   seeded 30 s waveforms -> log-mel (K1 on CUDA) -> greedy decode in
           bf16 with the int8 cross cache (encoder K2, loop K4), or beam
           search with ``--beam``;
  --train  one frozen-encoder train step in bf16 (encoder K2 forward), or
           with ``--cached-features`` on precomputed encoder outputs;

on whisper-``--model`` at full width with random weights from seed 0 (a
second, traced warm-up run precedes the profiled one). The
table lists each kernel (each operator, on the CPU) by self time with its
occurrences; the port's kernels (K1-K10) are summed beside it, and the
device total is set against the profiled run's wall (busy share). xprof's
per-op GB/s and bound-by columns have no ``torch.profiler`` counterpart.
``main`` returns the same as a dict.

  python -m whisper_ipa_torch.cli.profile_inference \\
      --model small --batch 8 --sample-len 32 [--train] [--top 25] \\
      [--logdir DIR] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import add_device_flag
from .profile_serving import port_kernel_times


def op_table(events, device: torch.device):
    """Per-op rows of ``key_averages()`` sorted by self time: the device's
    kernels on CUDA, the operators on the CPU."""
    rows = []
    for e in events:
        if e.key.startswith("ProfilerStep"):
            continue  # the schedule's step annotation (on both timelines)
        if device.type == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            self_us = e.self_device_time_total
        else:
            self_us = e.self_cpu_time_total
        if self_us <= 0:
            continue
        rows.append({
            "op": e.key,
            "occurrences": e.count,
            "self_ms": self_us / 1e3,
            "avg_us": self_us / max(e.count, 1),
        })
    rows.sort(key=lambda r: -r["self_ms"])
    return rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Profile the decode (or train) hot path on one device "
        "and print a per-op time table"
    )
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--sample-len", type=int, default=32)
    p.add_argument("--beam", type=int, default=0,
                   help="profile beam search at this width (0 = greedy)")
    p.add_argument("--train", action="store_true",
                   help="profile one train step instead of decode")
    p.add_argument("--cached-features", action="store_true",
                   help="with --train: feed precomputed encoder outputs "
                   "(the cache_encoder=True fine-tune regime)")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--logdir", default=None,
                   help="also export the run's Chrome trace to "
                   "LOGDIR/trace.json")
    p.add_argument("--json", default=None,
                   help="also write the full op table to this JSON file")
    add_device_flag(p)
    args = p.parse_args(argv)

    from ..audio import N_SAMPLES
    from ..config import get_config
    from ..models import init_params
    from ..ops import log_mel_spectrogram
    from ..tokenizer import get_tokenizer
    from ..train.loop import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)

    if args.train:
        from ..models import encode
        from ..train import create_train_state, train_step

        mel = torch.from_numpy(
            rng.standard_normal((args.batch, 3000, cfg.n_mels)).astype(
                np.float32
            )
        ).to(device)
        tok = np.full((args.batch, 48), 300, np.int64)
        tok[:, :4] = [50258, 50259, 50359, 50363]
        tok[:, -1] = 50257
        tokens = torch.from_numpy(tok).to(device)
        if args.cached_features:
            with torch.inference_mode():
                mel = encode(params, cfg, mel, dtype=torch.bfloat16)
            mel = mel.clone()  # a normal tensor for the autograd step
        state, tx = create_train_state(params, learning_rate=1e-5,
                                       freeze_encoder=True)

        def run():
            _, loss = train_step(
                state, mel, tokens, cfg, tx, 50257,
                freeze_encoder=True, dtype_name="bfloat16",
                inputs_are_features=args.cached_features,
            )
            float(loss)
    else:
        from ..decode import DecodingOptions, decode

        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages, language="en",
        )
        audio = torch.from_numpy(
            (rng.standard_normal((args.batch, N_SAMPLES)) * 0.1).astype(
                np.float32
            )
        ).to(device)
        options = DecodingOptions(
            language="en", without_timestamps=True,
            sample_len=args.sample_len,
            suppress_tokens=[-1, tokenizer.eot],
            fp16=True, kv_int8=True,
            beam_size=args.beam or None,
            length_penalty=1.0 if args.beam else None,
        )

        def run():
            with torch.inference_mode():
                mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
            decode(params, cfg, mel, options, tokenizer=tokenizer)

    t0 = time.perf_counter()
    run()  # warm-up: kernel builds, allocator, lazy initialisation
    _sync(device)
    print(f"# warm-up in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # one traced warm-up step first: the tracer can miss the kernels of the
    # first moments after it starts; the table reads the second run only.
    # The read run also keeps a pause from each edge of its window: the
    # tracer drops a kernel whose device timestamp falls outside the window,
    # and the first kernel launched right after the window opens (K1 in
    # decode) has been dropped so.
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    edge_pause_s = 0.05
    traced = {}

    def ready(prof):
        traced["events"] = prof.key_averages()
        if args.logdir:
            os.makedirs(args.logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.logdir, "trace.json"))

    with torch.profiler.profile(activities=activities, schedule=schedule,
                                on_trace_ready=ready) as prof:
        run()
        _sync(device)
        prof.step()
        time.sleep(edge_pause_s)
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = time.perf_counter() - t0
        time.sleep(edge_pause_s)
        prof.step()

    events = traced["events"]
    rows = op_table(events, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    total = sum(r["self_ms"] for r in rows)
    if device.type == "cuda":
        where = torch.cuda.get_device_name(device)
        port = port_kernel_times(
            [e for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA])
        busy = total / 1e3 / wall
        print(f"{'total device ms':>15s}: {total:9.1f}   (device {where}; "
              f"profiled run {wall * 1e3:.1f} ms, busy {busy:.1%})")
    else:  # operators' self time on the host: no device metric
        where, port, busy = "cpu", {}, None
        print(f"{'total CPU ms':>15s}: {total:9.1f}   (device cpu; profiled "
              f"run {wall * 1e3:.1f} ms)")
    for k, t in port.items():
        print(f"  {k}: {t['device_ms']:.3f} ms, {t['launches']} launches")
    print(f"{'self ms':>9s} {'n':>6s}  op")
    for r in rows[: args.top]:
        name = r["op"]
        if len(name) > 80:
            name = "…" + name[-79:]
        print(f"{r['self_ms']:9.3f} {r['occurrences']:6d}  {name}")
    return {"device": where, "rows": rows, "total_ms": total,
            "wall_s": wall, "busy_share": busy,
            "port_kernels": port}


if __name__ == "__main__":
    main()
