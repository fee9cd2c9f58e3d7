"""The program's spans on the benchmark's cells, on the card: what they cost
when they record, how well a call's child spans cover it, and whether
they reach the device's timeline.

    python3 perf/torch_span_cost.py --cells small.eval-long small.finetune \\
        --seconds 10 --rounds 1 --seed 7 --out artifacts/span_cost

Each cell is set up once as the benchmark sets it up (``benchmark/harness``,
the cell's seed). Then its measured window runs ``rounds`` times four times,
with ``timing.tracing()`` off, on, on, off, and each window's unit walls
(a batch or a chunk, host clock) are kept. From the
traced windows' records: each ``decode`` call's (or ``train.step``'s) direct
children's stream times summed against its own, and the mean host and
stream time of each span name. Last, one unit runs under the harness's
profiler (``harness/trace.profile``): the stretch's device operations whose
names are span markers (0 expected) and the markers among its host events.
One JSON line a cell on standard output and in ``<out>/<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.caches import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

import torch  # noqa: E402

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.cli import make_driver, power_limit  # noqa: E402
from benchmark.harness.trace import profile  # noqa: E402
from whisper_ipa_torch.utils import timing  # noqa: E402

ROOTS = {"eval_batch": "decode", "finetune": "train.step"}


def cover(recs, root_name):
    """[(root's stream ms, its direct children's summed stream ms)]."""
    kids = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            kids[r.parent] += r.stream_ms
    return [(r.stream_ms, kids[r.id]) for r in recs if r.name == root_name]


def means(recs):
    """{span name: [count, mean host ms, mean stream ms]}."""
    by = defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    return {n: [len(rs), statistics.fmean(r.host_ms for r in rs),
                statistics.fmean(r.stream_ms for r in rs)] for n, rs in by.items()}


def one_unit(drv, kind):
    """A callable running one batch or chunk, as the window does."""
    if kind == "eval_batch":
        return lambda: drv._batch(1 % drv.mix["distinct_batches"], keep=False)
    return lambda: drv._chunk(slice(0, drv.mix["distinct_batches"]))


def run_cell(cell, seed, seconds, rounds, device, device_name):
    kind = cell["mix"]["kind"]
    drv = make_driver(cell, seed, device, device_name)
    t0 = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t0
    walls = {"off": [], "on": []}
    recs = []
    for how in ["off", "on", "on", "off"] * rounds:
        if how == "on":
            with timing.tracing():
                out = drv.window(seconds, False)
            recs = timing.records()
        else:
            out = drv.window(seconds, False)
        walls[how].append(out["unit_walls_s"])
    st = profile(one_unit(drv, kind))
    on_device = [n for n, _, _ in st.device if timing.parse_marker(n)]
    host_marks = sum(1 for n, _, _ in st.host if timing.parse_marker(n))
    flat = {k: [w for ws in v for w in ws] for k, v in walls.items()}
    med = {k: statistics.median(v) for k, v in flat.items()}
    cov = cover(recs, ROOTS[kind])
    result = {
        "cell": cell["name"], "seed": seed, "setup_s": setup_s,
        "unit_walls_s": walls, "median_unit_s": med,
        "tracing_cost_pct": 100.0 * (med["on"] / med["off"] - 1.0),
        "cover": cov,
        "cover_share": [c / p for p, c in cov],
        "spans": means(recs),
        "device_events": len(st.device), "device_markers": len(on_device),
        "host_markers": host_marks,
    }
    if kind == "finetune":  # the steps' children against the host-clock step
        step_ms = 1e3 * med["off"] / drv.mix["distinct_batches"]
        parts = sum(result["spans"][n][2] for n in
                    ("train.forward", "train.backward", "train.optimizer"))
        result.update(step_ms_off=step_ms, children_over_step=parts / step_ms)
    drv.release()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", default=registry.cell_names())
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default="artifacts/span_cost")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = power_limit()
    device = torch.device("cuda", 0)
    for name in args.cells:
        res = run_cell(registry.cell(name), args.seed, args.seconds, args.rounds,
                       device, torch.cuda.get_device_name(device))
        res["card"] = card
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(res, f, indent=1)
        brief = {k: v for k, v in res.items() if k not in ("unit_walls_s", "cover")}
        print("SPANS " + json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
