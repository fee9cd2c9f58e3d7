"""One run of one cell: set-up, the measured window, the comparison, and
the result's line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, ``unit_walls_s`` (the host-clock time of each batch or
chunk outside the profiled stretch), ``card`` (its name and power limit as
``nvidia-smi`` reads them), and last ``checks``: each number compared
beside its limit.
The same numbers end standard error. Without a CUDA card, or with fewer
cards than the cell asks for, the run prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

from benchmark.harness import registry
from benchmark.harness.trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_ipa_tpu")


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_driver(cell: Dict, seed: int, device, device_name: str):
    """The cell's traffic driver, not yet set up."""
    ctx = SimpleNamespace(seed=seed, device=device, device_name=device_name,
                          dims=registry.dims(cell["config_file"]), mix=cell["mix"],
                          config_name=cell["config"])
    return registry.driver(cell["mix"]["kind"]).Driver(ctx)


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device,
             device_name: str, started: float) -> Dict:
    """Set up, measure, compare; returns the result's fields (``checks``
    last). ``started`` is the process's start on the wall clock."""
    import torch

    reported = registry.e2e(cell)
    drv = make_driver(cell, seed, device, device_name)
    drv.setup()
    setup_s = time.time() - started
    out = drv.window(seconds, trace)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release()
    readings = drv.check()
    limits = cell["limits"]
    checks = {n: {"value": readings[n], "limit": limits[n]} for n in limits}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if cuda else device.type, "kind": device_name,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "unit_walls_s": out["unit_walls_s"]}
    if trace:
        facts = out["facts"]
        result["metrics"] = registry.read_metrics(facts, list(reported))
        st = facts["stretch"]
        w = st.window if st is not None else None
        device_info["busy_s"] = st.busy_us() / 1e6 if w else 0.0
        device_info["window_s"] = (w[1] - w[0]) / 1e6 if w else 0.0
        if w:
            result["breakdown"] = breakdown(st)
    else:
        result["metrics"] = {name: {"value": out["e2e"][q], "unit": unit}
                             for name, (q, unit) in reported.items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv: List[str], started: float) -> int:
    args = parse(argv)
    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}. No result.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      name, started)
    card = f"{power_limit()} ({torch.cuda.device_count()} visible)"
    # every number names its card: the name, the power limit, the count
    result = {**{k: v for k, v in result.items() if k != "checks"}, "card": card,
              "checks": result["checks"]}
    print(f"benchmark: {args.workload} seed {args.seed} on {card}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)} in the measuring process. "
              "No result.", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {n} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
