"""Readings that set the limits of the audio language model cell's
comparison (``traffic/audio_llm_batch.py``), on the card.

For each seed, in one process: the program's readings (set-up, one batch
of the cell's own size, the comparison), and on the first ``--controls``
seeds the control's (the float8 reference in the program's place) and
each planted fault's: a served token altered, the second-best token
chosen at every step of the decode loop (``calibrate.second_best_tokens``),
the routed weights renormalised over the chosen experts, the null expert
given routed expert 0's weights, and the second shared expert dropped.
The benchmark's own runs never run this.

    python3 benchmark/calibrate_omni.py --workload omni.eval-long --seeds 1-12 --controls 3

One JSON line a reading goes to standard output and to ``--out``.
"""

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.caches import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import calibrate  # noqa: E402
from benchmark.harness import registry  # noqa: E402


@contextlib.contextmanager
def _patched(name, make):
    """``models.audio_llm.<name>`` replaced by ``make(real)`` inside."""
    import whisper_ipa_torch.models.audio_llm as m

    real = getattr(m, name)
    setattr(m, name, make(real))
    try:
        yield
    finally:
        setattr(m, name, real)


def renormalised():
    """Each token's routed weights divided by their sum over its chosen
    slots (the null one included), as a top-k router that renormalises."""
    def make(real):
        def route(n, router, cfg):
            r = real(n, router, cfg)
            return r._replace(weights=r.weights / r.weights.sum(-1, keepdim=True))
        return route
    return _patched("route", make)


def null_expert_computes():
    """The null expert given routed expert 0's weights: a token that chose
    it adds its probability times expert 0's output."""
    import whisper_ipa_torch.models.audio_llm as m

    def wrap(real):
        def moe(p, n, r, cfg, counts=None):
            y = real(p, n, r, cfg, counts).float()
            w = torch.where(r.slots == cfg.n_routed, r.weights, 0.0).sum(-1, keepdim=True)
            e0 = m._swiglu(n, p["experts_w1"][0].to(n.dtype), p["experts_w2"][0].to(n.dtype))
            return (y + w * e0.float()).to(n.dtype)
        return moe

    return _both(wrap)


@contextlib.contextmanager
def _both(wrap):
    with _patched("moe_static", wrap), _patched("moe_grouped", wrap):
        yield


def shared_dropped():
    """Only the first shared expert summed: the second left out."""
    def make(real):
        def shared(p, n):
            return real(dict(p, shared_w1=p["shared_w1"][:1], shared_w2=p["shared_w2"][:1]), n)
        return shared
    return _patched("_shared", make)


def planted(cell, seed, device, plant):
    """One batch of the cell with a fault planted in the program."""
    drv = calibrate.driver(cell, seed, device)
    with plant():
        drv.setup()
        drv.window(0.0, False)
    drv.release()
    return drv.check()


FAULTS = {"second_best": calibrate.second_best_tokens, "renormalised": renormalised,
          "null_expert_computes": null_expert_computes, "shared_dropped": shared_dropped}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_omni: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for n, seed in enumerate(calibrate.seeds(args.seeds)):
        control = n < args.controls
        t0 = time.time()
        drv = calibrate.driver(cell, seed, device)
        drv.setup()
        t1 = time.time()
        drv.window(0.0, False)  # one batch
        t2 = time.time()
        peak = torch.cuda.max_memory_allocated(device)
        drv.release()
        r = drv.check(control=control)
        t3 = time.time()
        emit({"seed": seed, "side": "program", **r, "setup_s": t1 - t0,
              "unit_s": t2 - t1, "check_s": t3 - t2, "peak_bytes": peak})
        if control:
            rng = np.random.default_rng([seed, 7])
            toks = [list(row) for row in drv.sample_tokens]
            row, pos = int(rng.integers(len(toks))), int(rng.integers(len(toks[0])))
            first = drv.cfg.first_special
            toks[row][pos] = int((toks[row][pos] + 1 + rng.integers(1000)) % first)
            drv.sample_tokens = toks
            emit({"seed": seed, "side": "fault:token_altered", **drv.check()})
            del drv
            torch.cuda.empty_cache()
            for name, plant in FAULTS.items():
                emit({"seed": seed, "side": f"fault:{name}",
                      **planted(cell, seed, device, plant)})
                torch.cuda.empty_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
