"""Readings that set the limits of a cell's comparison, on the card.

For each seed, in one process: the program's readings (set-up, one
batch of the cell's own size for the eval cells, the checked steps for
training; then the comparison), and on the first ``--controls`` seeds
the control's (the reference in float8 in the program's place), each
planted fault's (a served token altered; the second-best token chosen at
every step of the decode loop; half of a training batch left out), and
for the eval cells the program's own int8 linears as a second witness.
The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload small.eval-long --seeds 1-12 --controls 3

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

from benchmark.harness import cli, registry  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def driver(cell, seed, device):
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return cli.make_driver(cell, seed, device, name)


@contextlib.contextmanager
def second_best_tokens():
    """A wrong greedy choice planted in the program's decode loop: inside
    ``decode.decoding._greedy_decode`` every argmax over the vocabulary
    takes the second-best token, whose log-probability the loop reads
    from the same logits, so each row's ``avg_logprob`` stays consistent
    with the tokens it served."""
    import whisper_ipa_torch.decode.decoding as dec

    real_loop, real_argmax = dec._greedy_decode, torch.Tensor.argmax

    def second(self, dim=None, keepdim=False):
        if self.dim() == 2 and dim in (-1, 1) and self.is_floating_point():
            out = self.topk(2, dim=-1).indices[:, 1]
            return out[:, None] if keepdim else out
        return real_argmax(self, dim=dim, keepdim=keepdim)

    def loop(*a, **k):
        torch.Tensor.argmax = second
        try:
            return real_loop(*a, **k)
        finally:
            torch.Tensor.argmax = real_argmax

    dec._greedy_decode = loop
    try:
        yield
    finally:
        dec._greedy_decode = real_loop


def second_best(cell, seed, device):
    """One batch of the eval cell with ``second_best_tokens`` planted."""
    drv = driver(cell, seed, device)
    drv.setup()
    with second_best_tokens():
        drv.window(0.0, False)
    drv.release()
    return drv.check()


def int8_witness(cell, seed, device):
    """The program's own int8 linears on the cell's batch (``use_int8``)."""
    from whisper_ipa_torch.models.layers import use_int8_activations

    drv = driver(cell, seed, device)
    drv.setup()
    try:
        drv.use_int8()
        drv.window(0.0, False)
    finally:
        use_int8_activations(False)
    drv.release()
    return drv.check()


def half_batch(cell, seed, device):
    """The training cell's checked steps with half of each batch left
    out and the loss's mean taken over the rest, planted in the program's
    ``train_step``."""
    import whisper_ipa_torch.train.step as step

    real = step.train_step

    def half(state, mel, tokens, *a, **k):
        h = mel.shape[0] // 2
        return real(state, mel[:h], tokens[:h], *a, **k)

    step.train_step = half
    try:
        drv = driver(cell, seed, device)
        drv.setup()
    finally:
        step.train_step = real
    drv.release()
    return drv.check()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    kind = cell["mix"]["kind"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for n, seed in enumerate(seeds(args.seeds)):
        control = n < args.controls
        t0 = time.time()
        drv = driver(cell, seed, device)
        drv.setup()
        t1 = time.time()
        if kind == "eval_batch":
            drv.window(0.0, False)  # one batch
        t2 = time.time()
        peak = torch.cuda.max_memory_allocated(device)
        drv.release()
        r = drv.check(control=control)
        t3 = time.time()
        emit({"seed": seed, "side": "program", **r, "setup_s": t1 - t0,
              "unit_s": t2 - t1, "check_s": t3 - t2, "peak_bytes": peak})
        if control and kind == "eval_batch":
            emit({"seed": seed, "side": "witness:program_int8",
                  **int8_witness(cell, seed, device)})
            rng = np.random.default_rng([seed, 7])
            toks = [list(row) for row in drv.sample_tokens]
            row, pos = int(rng.integers(len(toks))), int(rng.integers(len(toks[0])))
            toks[row][pos] = int((toks[row][pos] + 1 + rng.integers(1000)) % drv.eot)
            drv.sample_tokens = toks
            emit({"seed": seed, "side": "fault:token_altered", **drv.check()})
            del drv
            torch.cuda.empty_cache()
            emit({"seed": seed, "side": "fault:second_best",
                  **second_best(cell, seed, device)})
        if control and kind == "finetune":
            del drv
            torch.cuda.empty_cache()
            emit({"seed": seed, "side": "fault:half_batch",
                  **half_batch(cell, seed, device)})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
