#!/usr/bin/env python3
"""The port's held-out generalization recipe at full width on one CUDA
card, and the perturbed and per-locale evaluations of each checkpoint.

For each ``--model NAME:STEPS`` (default ``tiny:600 small:3000``):
``examples/torch_generalization.py --model NAME --steps STEPS --bf16``
(256 synthesized training utterances, 48 held out, from random init,
encoder unfrozen, batch 16), then on its final checkpoint
``examples/torch_perturbed_eval.py`` with all seven conditions and
``examples/torch_corpus_report.py`` on the held-out split (the
synthesized set has no locales: one "unknown" group). Each run's wall and
its K1-K10 launches (``chip_smoke.py``'s counters, set to 0 before the
run and read after) are printed as one JSON line, and all of them go to
``<out>/examples_full.json`` with each run's logs (CSV and JSON); the
data, mel cache and checkpoints live in a temporary directory, removed
after each model's evaluations.

    python3 perf/torch_examples_full.py [--model tiny:600 small:3000] \\
        [--out artifacts/examples_full] [--remat]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", nargs="+", default=["tiny:600", "small:3000"],
                    help="NAME:STEPS, one run each, in order")
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "examples_full"))
    ap.add_argument("--remat", action="store_true",
                    help="passed to torch_generalization (activation "
                    "recomputation in the backward pass)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_examples_full needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smoke = load(ROOT / "chip_smoke.py", "chip_smoke_helpers")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "unknown"
    print(f"card: {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    results = {"card": card, "runs": []}

    def run(label, module, argv):
        smoke.reset_counts(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = load(ROOT / "examples" / f"{module}.py", module).main(argv)
        wall = time.time() - t0
        counts = smoke.nonzero(smoke.read_counts(torch))
        line = {"run": label, "wall_s": round(wall, 2), "launches": counts,
                "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
                "result": out}
        results["runs"].append(line)
        print("EXAMPLE " + json.dumps(line, ensure_ascii=False), flush=True)
        with open(os.path.join(args.out, "examples_full.json"), "w") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        return out

    for spec in args.model:
        name, steps = spec.split(":")
        work = tempfile.mkdtemp(prefix=f"examples_{name}_")
        try:
            run(f"generalization {name} {steps}", "torch_generalization",
                ["--model", name, "--steps", steps, "--bf16", "--out", work]
                + (["--remat"] if args.remat else []))
            common = ["--run-dir", os.path.join(work, "run"),
                      "--checkpoint",
                      os.path.join(work, "run", f"checkpoint-{steps}"),
                      "--data", os.path.join(work, "data", "heldout.json"),
                      "--model", name]
            conds = run(f"perturbed_eval {name}", "torch_perturbed_eval",
                        common)["conditions"]
            report = run(f"corpus_report {name}", "torch_corpus_report",
                         common + ["--mel-cache-dir",
                                   os.path.join(work, "melcache")])
            print(f"[{name}] perturbed: " + "; ".join(
                f"{c} PER {m['per']:.2f}% PFER {m['pfer']:.2f}%"
                for c, m in conds.items())
                + f"; report overall PER {report['overall']['per']:.2f}% "
                f"PFER {report['overall']['pfer']:.2f}%", flush=True)
            logs = os.path.join(args.out, name)
            os.makedirs(logs, exist_ok=True)
            for f in os.listdir(os.path.join(work, "run")):
                if f.endswith((".csv", ".json")):
                    shutil.copy(os.path.join(work, "run", f), logs)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
