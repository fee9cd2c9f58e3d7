"""Acoustic train/test decoupling through the PyTorch port: evaluate a
trained checkpoint on perturbed versions of the held-out synthetic split.

The port's counterpart of examples/perturbed_eval.py, with the same
conditions, seeds, flags and report keys: additive noise at several SNRs,
synthetic room reverb, both together, and an unseen speaker (the
transcription re-synthesized with a jittered f0 and phone duration and a
fresh seed). Each batch goes waveform -> log-mel on the device (K1 on a
CUDA card) -> greedy decode, the tail batch padded with its last row.

Run (on a CUDA card unless told otherwise):
  python examples/torch_perturbed_eval.py \\
      --run-dir <dir>/run --model tiny \\
      --checkpoint <dir>/run/checkpoint-600 \\
      --data <dir>/data/heldout.json --batch 16 [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONDITIONS = ["clean", "snr20", "snr10", "snr5", "reverb", "snr10+reverb",
              "speaker"]


def add_noise(audio: np.ndarray, snr_db: float, rng) -> np.ndarray:
    p_sig = float(np.mean(audio**2)) + 1e-12
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return audio + rng.standard_normal(len(audio)).astype(np.float32) * (
        p_noise**0.5
    )


def add_reverb(audio: np.ndarray, rt60: float = 0.3, sr: int = 16000,
               rng=None) -> np.ndarray:
    """Synthetic room impulse response: exponentially-decaying noise."""
    n = int(rt60 * sr)
    t = np.arange(n) / sr
    rir = (rng.standard_normal(n) * np.exp(-6.9 * t / rt60)).astype(
        np.float32
    )
    rir[0] = 1.0  # direct path
    rir /= np.sqrt(np.sum(rir**2))
    wet = np.convolve(audio, rir)[: len(audio)].astype(np.float32)
    peak = np.max(np.abs(wet)) + 1e-9
    return wet / peak * (np.max(np.abs(audio)) + 1e-9)


def resynth_speaker(entry: dict, idx: int) -> np.ndarray:
    """Unseen speaker realization: jittered f0/duration, fresh seed."""
    from whisper_ipa_torch.data.synth import synthesize_ipa

    rng = np.random.default_rng(777_000 + idx)
    f0 = float(rng.uniform(70.0, 260.0))  # outside no one speaker's range
    dur = float(rng.uniform(0.08, 0.16))
    return synthesize_ipa(
        entry["ipa_transcription"], duration=dur, f0=f0,
        seed=999_000_000 + idx,  # disjoint from every training seed
    ).astype(np.float32)


def perturb(audio: np.ndarray, cond: str, idx: int,
            entries: list) -> np.ndarray:
    """``cond``'s parts ("snr10+reverb") applied in order, one
    default_rng(123_000 + idx) for the utterance."""
    rng = np.random.default_rng(123_000 + idx)
    for part in cond.split("+"):
        if part == "clean":
            pass
        elif part.startswith("snr"):
            audio = add_noise(audio, float(part[3:]), rng)
        elif part == "reverb":
            audio = add_reverb(audio, rng=rng)
        elif part == "speaker":
            audio = resynth_speaker(entries[idx], idx)
        else:
            raise ValueError(f"unknown condition {part!r}")
    return audio


def decode_split(params, cfg, tokenizer, entries: list, options,
                 batch: int, cond: str = "clean"):
    """(references, hypotheses) of ``entries`` under ``cond``: each batch's
    waveforms -> log-mel on the parameters' device (K1 on a card) ->
    decode(), the tail batch padded with its last row."""
    import torch

    from whisper_ipa_torch.audio import load_audio, pad_or_trim
    from whisper_ipa_torch.decode import decode
    from whisper_ipa_torch.ops import log_mel_spectrogram

    dev = params["decoder"]["token_embedding"].device
    n = len(entries)
    refs, hyps = [], []
    for start in range(0, n, batch):
        idx = list(range(start, min(start + batch, n)))
        padded = idx + [idx[-1]] * (batch - len(idx))
        rows = []
        for i in padded:
            audio = load_audio(entries[i]["audio_path"])
            if cond != "clean":
                audio = perturb(audio, cond, i, entries)
            rows.append(pad_or_trim(audio))
        with torch.inference_mode():
            mel = log_mel_spectrogram(
                torch.from_numpy(np.stack(rows)).to(dev), n_mels=cfg.n_mels)
        results = decode(params, cfg, mel, options, tokenizer=tokenizer)
        for k, i in enumerate(idx):
            refs.append(entries[i]["ipa_transcription"].strip())
            hyps.append(results[k].text.strip())
    return refs, hyps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--sample-len", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card) or "cpu"')
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--out", default=None)
    p.add_argument("--conditions", nargs="+", default=CONDITIONS)
    args = p.parse_args(argv)

    from whisper_ipa_torch.config import get_config
    from whisper_ipa_torch.decode import DecodingOptions
    from whisper_ipa_torch.metrics import evaluate_batch
    from whisper_ipa_torch.models import load_checkpoint_model
    from whisper_ipa_torch.tokenizer import get_tokenizer
    from whisper_ipa_torch.train.loop import (load_or_init_params,
                                              resolve_device)

    dev = resolve_device("cpu" if args.cpu else args.device)
    ckpt = args.checkpoint or os.path.join(args.run_dir, "best-checkpoint")
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, None, device=dev)
    params, n_loaded = load_checkpoint_model(ckpt, params, full=True)
    print(f"loaded {n_loaded} tensors from {ckpt}")
    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual, num_languages=cfg.num_languages
    )

    with open(args.data) as f:
        entries = json.load(f)
    if args.num_samples:
        entries = entries[: args.num_samples]
    n = len(entries)
    options = DecodingOptions(
        language=None, without_timestamps=True, length_penalty=1.0,
        sample_len=args.sample_len,
    )

    report = {"checkpoint": ckpt, "model": args.model, "n": n,
              "conditions": {}}
    for cond in args.conditions:
        t0 = time.time()
        refs, hyps = decode_split(params, cfg, tokenizer, entries, options,
                                  args.batch, cond)
        m = evaluate_batch(refs, hyps)
        dt = time.time() - t0
        report["conditions"][cond] = {
            "per": m["per"], "pfer": m["pfer"],
            "per_std": m["per_std"], "pfer_std": m["pfer_std"],
            "elapsed_s": round(dt, 1),
        }
        print(
            f"{cond:>12}: PER {m['per']:.2f}%  PFER {m['pfer']:.2f}%  "
            f"({n} utts, {dt:.0f}s)",
            flush=True,
        )

    out = args.out or os.path.join(args.run_dir, "perturbed_eval.json")
    with open(out, "w") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
