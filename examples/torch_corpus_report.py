"""Per-language held-out report for a checkpoint, through the PyTorch port.

The port's counterpart of examples/corpus_report.py, with the same flags
and report keys: decode the held-out split with a trained checkpoint
(greedy, the tail batch padded to the batch size and its pad rows
dropped), break PER/PFER down by locale, and add the top phone confusions
(metrics/analysis.py), writing a JSON report next to the checkpoint.
With --mel-cache-dir the cache is filled on the device first (K1 on a
CUDA card).

Run (on a CUDA card unless told otherwise):
  python examples/torch_corpus_report.py --run-dir <dir>/run_tiny \\
      --data <dir>/data/test.json --model tiny \\
      --mel-cache-dir <dir>/melcache [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="default: <run-dir>/best-checkpoint")
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="tiny")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--sample-len", type=int, default=None,
                   help="decode cap (default: model n_text_ctx budget)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card) or "cpu"')
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--out", default=None,
                   help="default: <run-dir>/corpus_report.json")
    args = p.parse_args(argv)

    import torch

    from whisper_ipa_torch.config import get_config
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.metrics import evaluate_batch
    from whisper_ipa_torch.metrics.analysis import confusion_analysis
    from whisper_ipa_torch.models import load_checkpoint_model
    from whisper_ipa_torch.train.loop import (load_or_init_params,
                                              resolve_device)

    dev = resolve_device("cpu" if args.cpu else args.device)
    ckpt = args.checkpoint or os.path.join(args.run_dir, "best-checkpoint")
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, None, device=dev)
    params, n_loaded = load_checkpoint_model(ckpt, params, full=True)
    print(f"loaded {n_loaded} tensors from {ckpt}")

    ds = create_data_loader(
        args.data, n_mels=cfg.n_mels, mel_cache_dir=args.mel_cache_dir
    )
    if args.mel_cache_dir:
        ds.precompute_mels(dev)
    entries = ds.data  # locales come from the same parsed list
    n = min(args.num_samples or len(ds), len(ds))
    options = DecodingOptions(
        language=None,
        without_timestamps=True,
        length_penalty=1.0,
        **({"sample_len": args.sample_len} if args.sample_len else {}),
    )

    refs, hyps, locales = [], [], []
    t0 = time.time()
    for start in range(0, n, args.batch):
        idx = list(range(start, min(start + args.batch, n)))
        # the tail batch padded to the full batch size (its last index
        # repeated), as the JAX example does; pad rows are dropped below
        n_real = len(idx)
        padded = idx + [idx[-1]] * (args.batch - n_real)
        batch = ds.get_batch(padded)
        results = decode(
            params, cfg, torch.from_numpy(batch["mel_features"]).to(dev),
            options, tokenizer=ds.tokenizer,
        )
        for k, i in enumerate(idx):
            refs.append(batch["ipa_texts"][k].strip())
            hyps.append(results[k].text.strip())
            locales.append(entries[i].get("locale") or "unknown")
        done = start + len(idx)
        rate = done / (time.time() - t0)
        print(
            f"  {done}/{n} decoded ({rate:.2f} utt/s, "
            f"eta {(n - done) / rate:.0f}s)",
            flush=True,
        )

    overall = evaluate_batch(refs, hyps)
    by_locale = {}
    groups = defaultdict(list)
    for r, h, loc in zip(refs, hyps, locales):
        groups[loc].append((r, h))
    for loc in sorted(groups):
        pairs = groups[loc]
        m = evaluate_batch([r for r, _ in pairs], [h for _, h in pairs])
        by_locale[loc] = {
            "per": m["per"], "pfer": m["pfer"], "n": len(pairs),
        }

    conf = confusion_analysis(refs, hyps)

    report = {
        "checkpoint": ckpt,
        "model": args.model,
        "n_scored": len(refs),
        "overall": {"per": overall["per"], "pfer": overall["pfer"],
                    "per_std": overall["per_std"],
                    "pfer_std": overall["pfer_std"]},
        "by_locale": by_locale,
        "phone_accuracy": conf["phone_accuracy"],
        "top_substitutions": [
            [r, h, c] for (r, h), c in conf["top_substitutions"]
        ],
        "top_insertions": [[h, c] for h, c in conf["top_insertions"]],
        "top_deletions": [[r, c] for r, c in conf["top_deletions"]],
        "per_dist": conf["per"],
        "pfer_dist": conf["pfer"],
    }
    out = args.out or os.path.join(args.run_dir, "corpus_report.json")
    with open(out, "w") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)

    print(f"\n{'locale':<10} {'n':>5} {'PER%':>8} {'PFER%':>8}")
    for loc, m in sorted(by_locale.items()):
        print(f"{loc:<10} {m['n']:>5} {m['per']:>8.2f} {m['pfer']:>8.2f}")
    print(
        f"{'OVERALL':<10} {len(refs):>5} {overall['per']:>8.2f} "
        f"{overall['pfer']:>8.2f}"
    )
    print(f"\nwrote {out}")
    return report


if __name__ == "__main__":
    main()
