"""Held-out generalization experiment through the PyTorch port.

Trains a Whisper model from random init on a few hundred synthetic
utterances and reports PER/PFER on HELD-OUT utterances (disjoint phone
sequences AND synthesis seeds) through the port's validate() path: the
port's counterpart of examples/generalization.py, with the same data set,
recipe, seeds and output keys. The mel cache is filled on the device
first (K1 on a CUDA card); training runs the encoder unfrozen (K2
forward, K5 backward in bf16).

Run (on a CUDA card unless told otherwise):
  python examples/torch_generalization.py --model tiny --steps 600 \\
      --bf16 --out <dir> [--device cpu | --cpu]

Outputs <out>/run/generalization.json with the random-model floor, the
train-set score, and the held-out score.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# a synthesizable inventory with distinct spectral signatures
PHONES = [
    "i", "u", "a", "o", "e", "ɛ", "ɔ", "æ",
    "p", "t", "k", "b", "d", "ɡ",
    "s", "z", "ʃ", "f", "v", "x",
    "m", "n", "l", "r", "j", "w",
]


def sequences(n_train: int, n_heldout: int, min_len: int = 3,
              max_len: int = 8) -> dict:
    """{split: [(phones, synthesis seed)]}: disjoint random phone sequences
    from default_rng(42), synthesis seeds from 0 (train) and 1 000 000
    (held-out)."""
    rng = np.random.default_rng(42)
    seen = set()

    def sample_seq():
        while True:
            length = int(rng.integers(min_len, max_len + 1))
            seq = tuple(rng.choice(PHONES, size=length).tolist())
            if seq not in seen:
                seen.add(seq)
                return seq

    return {split: [(sample_seq(), seed0 + i) for i in range(n)]
            for split, n, seed0 in (("train", n_train, 0),
                                    ("heldout", n_heldout, 1_000_000))}


def make_dataset(root: str, n_train: int, n_heldout: int,
                 min_len: int = 3, max_len: int = 8):
    """Disjoint random phone sequences; separate synth seeds per split.
    Writes WAVs and the pipeline's JSON for each split; returns
    (train.json, heldout.json)."""
    from whisper_ipa_torch.audio import write_wav
    from whisper_ipa_torch.data.synth import synthesize_phonemes

    paths = {}
    for split, items in sequences(n_train, n_heldout, min_len,
                                  max_len).items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        entries = []
        for i, (seq, seed) in enumerate(items):
            path = os.path.join(d, f"utt{i}.wav")
            write_wav(path, synthesize_phonemes(list(seq), seed=seed))
            entries.append(
                {
                    "audio_path": path,
                    "ipa_transcription": "".join(seq),
                    "speaker_id": f"synth{seed}",
                    "dataset_source": "synthetic",
                }
            )
        paths[split] = os.path.join(root, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(entries, f, ensure_ascii=False)
    return paths["train"], paths["heldout"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="tiny")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-heldout", type=int, default=48)
    p.add_argument("--val-samples", type=int, default=48)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "gen_exp"))
    p.add_argument("--bf16", action="store_true")
    p.add_argument(
        "--remat", action="store_true",
        help="recompute each block's activations in the backward pass "
        "(full fine-tunes of the larger models)",
    )
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card) or "cpu"')
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)

    from whisper_ipa_torch.config import get_config
    from whisper_ipa_torch.data import create_data_loader
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.train.loop import resolve_device, train, validate

    dev = resolve_device("cpu" if args.cpu else args.device)
    train_json, heldout_json = make_dataset(
        os.path.join(args.out, "data"), args.n_train, args.n_heldout
    )
    out_dir = os.path.join(args.out, "run")
    cfg = get_config(args.model)
    mel_cache = os.path.join(args.out, "melcache")
    # the mel cache train() reads, filled on the device (K1 on a card)
    for path in (train_json, heldout_json):
        create_data_loader(path, n_mels=cfg.n_mels,
                           mel_cache_dir=mel_cache).precompute_mels(dev)

    # random-model floor on the held-out set (chance performance)
    heldout_ds = create_data_loader(heldout_json, n_mels=cfg.n_mels)
    floor = validate(
        init_params(cfg, seed=1, device=dev),
        cfg,
        heldout_ds,
        heldout_ds.tokenizer,
        num_samples=min(16, args.n_heldout),
    )
    print(f"\nRandom-model floor: PER {floor['per']:.2f}% "
          f"PFER {floor['pfer']:.2f}%")

    summary = train(
        model_name=args.model,
        train_data_path=train_json,
        test_data_path=heldout_json,
        output_dir=out_dir,
        num_steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        validate_every=max(args.steps // 3, 1),
        save_every=0,
        freeze_encoder=False,  # random init: the encoder must learn too
        warmup_steps=50,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat,
        accum_steps=args.accum_steps,
        final_validate=True,
        final_validate_samples=args.val_samples,
        mel_cache_dir=mel_cache,
        device=str(dev),
    )
    if "final_per" not in summary:
        raise SystemExit(
            f"training stopped early (emergency checkpoint?): {summary}"
        )

    # train-set score (same decode path) for the generalization gap
    train_ds = create_data_loader(train_json, n_mels=cfg.n_mels)
    from whisper_ipa_torch.models import load_checkpoint_model
    from whisper_ipa_torch.train import latest_checkpoint

    ckpt = latest_checkpoint(out_dir)
    params, _ = load_checkpoint_model(
        ckpt, init_params(cfg, seed=0, device=dev), full=True
    )
    train_score = validate(
        params, cfg, train_ds, train_ds.tokenizer,
        num_samples=min(48, args.n_train),
    )

    result = {
        "model": args.model,
        "steps": args.steps,
        "n_train": args.n_train,
        "n_heldout": args.n_heldout,
        "floor_per": floor["per"],
        "floor_pfer": floor["pfer"],
        "train_per": train_score["per"],
        "train_pfer": train_score["pfer"],
        "heldout_per": summary["final_per"],
        "heldout_pfer": summary["final_pfer"],
        "final_loss": summary["final_loss"],
    }
    with open(os.path.join(out_dir, "generalization.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("\nGENERALIZATION " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
