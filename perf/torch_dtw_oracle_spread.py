"""The DTW phone-timestamp oracle's spread over training trajectories.

The oracle of ``tests/test_word_timestamps.py`` (and of the PyTorch port's
``tests/test_torch_learning.py``) trains a micro Whisper 400 steps at lr
3e-3 on eight synthesized utterances, then scores the cross-attention phone
times against the synthesizer's true boundaries. This script asks whether
the port's scores differ from the JAX package's by more than rounding does.
From the JAX package's seed-0 init (the reference test's start) it runs:

  - ``jax``: the JAX package, the reference trajectory;
  - ``port``: the port from the same weights;
  - ``jax-nudge-S`` / ``port-nudge-S``: either package from the seed-0
    weights with every matrix scaled by (1 + 1e-7 * N(0, 1)) drawn from
    seed S, a rounding-sized change of the start;
  - ``jax-seed-S``: the JAX package from its seed-S init.

For each run it prints the final loss, the mean and p90 boundary error, the
first utterance's largest error (ms, the reference test's third bound is
60), the largest relative loss difference from the reference trajectory
over the first 20 steps, and the parameters' relative distance from it
(||theta - theta_jax|| / ||theta_jax|| over all weights) at steps 50, 100,
200 and 400.

Run on the CPU from the repository root (about 40 s a run on one thread):

  python perf/torch_dtw_oracle_spread.py                       # every run
  python perf/torch_dtw_oracle_spread.py port jax-nudge-1 ...  # some runs
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_learning as oracle  # noqa: E402
from whisper_ipa_tpu.decode.word_timestamps import (  # noqa: E402
    phone_timestamps as jax_phone_timestamps,
)
from whisper_ipa_tpu.models import flatten_params as jax_flatten  # noqa: E402
from whisper_ipa_tpu.models import init_params as jax_init  # noqa: E402
from whisper_ipa_tpu.models import unflatten_params as jax_unflatten  # noqa: E402
from whisper_ipa_tpu.train import create_train_state as jax_state  # noqa: E402
from whisper_ipa_tpu.train import train_step as jax_step  # noqa: E402
from whisper_ipa_torch.decode import phone_timestamps  # noqa: E402
from whisper_ipa_torch.models import params_from_numpy, params_to_numpy  # noqa: E402
from whisper_ipa_torch.tokenizer import get_tokenizer  # noqa: E402
from whisper_ipa_torch.train import create_train_state, train_step  # noqa: E402

torch.set_num_threads(1)
STEPS = oracle.ORACLE_STEPS
SNAPSHOTS = (50, 100, 200, 400)
PARITY_STEPS = oracle.PARITY_STEPS
NUDGE = 1e-7
DEFAULT_RUNS = (["jax", "port"] + [f"jax-nudge-{s}" for s in range(1, 9)]
                + [f"port-nudge-{s}" for s in range(1, 5)]
                + [f"jax-seed-{s}" for s in range(1, 4)])


def score(times_of, aligns):
    """(mean, p90, first utterance's max) boundary error in ms."""
    errors, first = [], []
    for i, ipa in enumerate(oracle.ORACLE_IPAS):
        ts = times_of(i, ipa, aligns[i][-1][2])
        for (_, start, end), d in zip(aligns[i], ts):
            pair = [abs(d["start"] - start), abs(d["end"] - end)]
            errors += pair
            if i == 0:
                first += pair
    e = np.array(errors) * 1e3
    return e.mean(), np.percentile(e, 90), max(first) * 1e3


def run_jax(flat, jcfg, mels, tokens, aligns, tok):
    state, tx = jax_state(
        jax_unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
        learning_rate=oracle.LR, freeze_encoder=False)
    mel, toks = jnp.asarray(mels), jnp.asarray(tokens.astype(np.int32))
    losses, snaps = [], {}
    for step in range(1, STEPS + 1):
        state, loss = jax_step(state, mel, toks, jcfg, tx, tok.eot,
                               freeze_encoder=False)
        losses.append(float(loss))
        if step in SNAPSHOTS:
            snaps[step] = {k: np.asarray(v)
                           for k, v in jax_flatten(state.params).items()}
    return losses, snaps, score(
        lambda i, ipa, sec: jax_phone_timestamps(
            state.params, jcfg, tok.encode(ipa), mel[i][None], tokenizer=tok,
            audio_seconds=sec), aligns)


def run_port(flat, jcfg, mels, tokens, aligns, tok):
    state, tx = create_train_state(params_from_numpy(flat),
                                   learning_rate=oracle.LR,
                                   freeze_encoder=False)
    mel, toks = torch.from_numpy(mels), torch.from_numpy(tokens)
    losses, snaps = [], {}
    for step in range(1, STEPS + 1):
        state, loss = train_step(state, mel, toks, oracle.CFG, tx, tok.eot,
                                 freeze_encoder=False)
        losses.append(float(loss))
        if step in SNAPSHOTS:
            # copies: the optimizer updates the tensors in place
            snaps[step] = {k: v.copy()
                           for k, v in params_to_numpy(state.params).items()}
    return losses, snaps, score(
        lambda i, ipa, sec: phone_timestamps(
            state.params, oracle.CFG, tok.encode(ipa), mel[i][None],
            tokenizer=tok, audio_seconds=sec), aligns)


def distance(a, b) -> float:
    """||a - b|| / ||b|| over every weight of two flat parameter dicts."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", default=DEFAULT_RUNS,
                    help="runs to make (default: all of them)")
    args = ap.parse_args()

    tok = get_tokenizer(multilingual=True, language="en")
    mels, tokens, aligns = oracle.build_oracle_set(tok)
    jcfg = oracle.jax_config()

    def jax_flat(seed):
        return {k: np.asarray(v)
                for k, v in jax_flatten(jax_init(jcfg, seed=seed)).items()}

    def nudged(seed):
        rng = np.random.default_rng(seed)
        return {k: (v * (1 + NUDGE * rng.standard_normal(v.shape))).astype(
            v.dtype) if v.ndim == 2 else v for k, v in flat0.items()}

    flat0 = jax_flat(0)
    ref_losses, ref_snaps, ref_score = run_jax(flat0, jcfg, mels, tokens,
                                               aligns, tok)
    for name in args.runs:
        side, kind, seed = (name.split("-") + ["", ""])[:3]
        start = (flat0 if not kind else nudged(int(seed)) if kind == "nudge"
                 else jax_flat(int(seed)))
        if name == "jax":
            losses, snaps, got = ref_losses, ref_snaps, ref_score
        else:
            run = run_jax if side == "jax" else run_port
            losses, snaps, got = run(start, jcfg, mels, tokens, aligns, tok)
        parity = max(abs(a - b) / abs(b) for a, b in
                     zip(losses[:PARITY_STEPS], ref_losses[:PARITY_STEPS]))
        drift = ", ".join(f"{s}: {distance(snaps[s], ref_snaps[s]):.3e}"
                          for s in SNAPSHOTS)
        print(f"{name}: loss {losses[-1]:.4f}; mean {got[0]:.1f} ms, p90 "
              f"{got[1]:.1f} ms, first utterance max {got[2]:.1f} ms; "
              f"{PARITY_STEPS}-step loss max rel diff from jax {parity:.3e}; "
              f"parameter distance from jax at step {drift}", flush=True)


if __name__ == "__main__":
    main()
