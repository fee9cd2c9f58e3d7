"""CLI: train Medusa draft heads on a fine-tuned model's own data.

Counterpart of ``whisper_ipa_tpu/cli/train_medusa.py``. The base model
stays frozen: each step teacher-forces one batch through the model once
(bf16 activations, under ``torch.no_grad()``), then fits the K residual
heads (``models/medusa.py``) with Adam (``optax.adam``'s numerics: no clip,
no weight decay) to predict tokens k + 2 positions ahead from the final
hidden states. The heads land in their own safetensors file, which
``cli.serve --draft-model medusa --medusa-weights <file>`` reads; every
``--save-every`` steps a snapshot goes to ``<output>.partial``. After
training, the heads' per-head top-4 hit rates on batches of the data are
written beside them as ``<output>.accuracy.json``, from which
``decode.medusa_tree.tree_for_heads`` builds the verification tree;
``--measure-only`` (re)writes that file for existing heads.
``--steps-per-call`` C draws C batches at a time and runs their steps as
one chunk, its mels stacked in bf16 and its tokens EOT-padded to the
widest (``train.chunking``); the host reads the loss once a chunk, and
logs and snapshots where a chunk crosses the cadence, as the reference.

  python -m whisper_ipa_torch.cli.train_medusa \\
      --model small --checkpoint checkpoints/best-checkpoint \\
      --train-data data/train_ipa.json --steps 2000 \\
      --n-heads 4 --output medusa_heads.safetensors
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import add_device_flag

TOP_C = 4


def frozen_hidden(params, cfg, mel, tokens):
    """The frozen model's teacher-forced final hidden states (B, T, d) in
    bf16, as the reference's training and measurement read them."""
    from ..models.whisper import decoder_hidden, encode
    from ..ops.precision import full_fp32

    with torch.no_grad(), full_fp32():
        feats = encode(params, cfg, mel, dtype=torch.bfloat16)
        return decoder_hidden(params, cfg, tokens, feats, dtype=torch.bfloat16)


def measure_head_accuracy(params, cfg, medusa, dataset, eot,
                          batch_size: int = 8, seed: int = 0,
                          top_c: int = TOP_C, n_batches: int = 4):
    """Per-head top-C hit rates on ``n_batches`` batches drawn from
    ``dataset`` with ``np.random.default_rng(seed + 1)``.

    Head k on h_t proposes the token at t + k + 2; hits are counted
    against the real tokens, masked past the first EOT. Returns an
    (n_heads x top_c) nested list, what ``optimize_tree`` maximizes
    expected acceptance from.
    """
    from ..models.medusa import medusa_propose_topk, valid_target_mask

    device = params["decoder"]["token_embedding"].device
    n_heads = len(medusa["heads"])
    hits = np.zeros((n_heads, top_c))
    totals = np.zeros(n_heads)
    eval_rng = np.random.default_rng(seed + 1)
    for _ in range(n_batches):
        idx = eval_rng.choice(len(dataset), batch_size, replace=True)
        batch = dataset.get_batch(idx)
        mel = torch.from_numpy(batch["mel_features"]).to(device)
        tokens = torch.from_numpy(batch["tokens"]).long().to(device)
        hidden = frozen_hidden(params, cfg, mel, tokens)
        T = tokens.shape[1]
        with torch.no_grad():
            topk = medusa_propose_topk(medusa, params, hidden, top_c,
                                       torch.bfloat16).cpu().numpy()
        valid = valid_target_mask(tokens, eot).cpu().numpy()  # (B, T)
        tok_np = tokens.cpu().numpy()
        for k in range(n_heads):
            tgt_pos = np.arange(T) + k + 2
            ok = tgt_pos < T
            tgt = tok_np[:, np.minimum(tgt_pos, T - 1)]  # (B, T)
            mask = valid[:, np.minimum(tgt_pos, T - 1)] & ok[None, :]
            match = topk[:, :, k, :] == tgt[:, :, None]  # (B, T, C)
            for c in range(top_c):
                hits[k, c] += float((match[:, :, c] & mask).sum())
            totals[k] += float(mask.sum())
    return (hits / np.maximum(totals, 1.0)[:, None]).tolist()


def write_accuracy(path: str, probs) -> str:
    """``<heads>.accuracy.json``, the file ``tree_for_heads`` reads."""
    sidecar = path + ".accuracy.json"
    with open(sidecar, "w") as f:
        json.dump({"head_topk_accuracy": probs, "top_c": TOP_C}, f)
    print("head top-1 accuracy: " + ", ".join(f"{p[0]:.3f}" for p in probs)
          + f" -> {sidecar}")
    return sidecar


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Medusa speculative-decoding heads (frozen base "
        "model)"
    )
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument(
        "--full-checkpoint", action="store_true",
        help="overlay ALL tensors from --checkpoint (encoder included) "
        "instead of the decoder-only reference contract: required for "
        "checkpoints of full fine-tunes, else the heads fit hidden states "
        "from a random encoder",
    )
    p.add_argument("--weights", default=None)
    p.add_argument("--train-data", required=True)
    p.add_argument("--output", default="medusa_heads.safetensors")
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--language", default="en")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--steps-per-call", type=int, default=8,
        help="steps a chunk: C batches stacked and uploaded at once, the "
        "same batch sequence and step math as one at a time",
    )
    p.add_argument(
        "--save-every", type=int, default=250,
        help="periodic head snapshot to <output>.partial; 0 disables",
    )
    p.add_argument(
        "--measure-only", action="store_true",
        help="skip training: load EXISTING heads from --output, measure "
        "per-head top-C accuracy on --train-data, and (re)write the "
        "<output>.accuracy.json file that tree_for_heads optimizes the "
        "verification tree from",
    )
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..config import get_config
    from ..data.dataset import create_data_loader
    from ..decode.medusa_tree import optimize_tree
    from ..models import flatten_params, load_checkpoint_model
    from ..models.medusa import (
        init_medusa_params,
        load_medusa,
        save_medusa,
        train_medusa_step,
    )
    from ..train.chunking import pow2_floor, stack_pad_batches
    from ..train.loop import load_or_init_params, resolve_device
    from ..train.optimizer import Optimizer

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights, device=device)
    if args.checkpoint:
        params, n = load_checkpoint_model(
            args.checkpoint, params, full=args.full_checkpoint
        )
        scope = "model" if args.full_checkpoint else "decoder"
        print(f"Loaded {n} {scope} tensors from {args.checkpoint}")

    dataset = create_data_loader(
        args.train_data,
        multilingual=cfg.multilingual,
        n_mels=cfg.n_mels,
        language=args.language,
        mel_cache_dir=args.mel_cache_dir,
    )
    print(f"{len(dataset)} training samples")
    eot = dataset.tokenizer.eot

    if args.measure_only:
        medusa = load_medusa(args.output, device=device)
        probs = measure_head_accuracy(params, cfg, medusa, dataset, eot,
                                      batch_size=args.batch_size,
                                      seed=args.seed)
        write_accuracy(args.output, probs)
        print(f"optimized tree (12 nodes): {optimize_tree(probs, 12)}")
        return probs

    medusa = init_medusa_params(cfg, n_heads=args.n_heads, seed=args.seed,
                                device=device)
    # optax.adam: no clip, no weight decay
    tx = Optimizer(learning_rate=args.learning_rate, max_grad_norm=None,
                   weight_decay=0.0, freeze_encoder=False)
    opt_state = tx.init(flatten_params(medusa))

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    step = 0
    spc = max(1, args.steps_per_call)
    while step < args.steps:
        n = pow2_floor(min(spc, args.steps - step))
        batches = [
            dataset.get_batch(rng.choice(len(dataset), args.batch_size,
                                         replace=True))
            for _ in range(n)
        ]
        # bf16 mels: the frozen forward casts them at entry anyway
        mels, toks = stack_pad_batches(batches, eot, bf16_mels=True)
        mels, toks = mels.to(device), toks.long().to(device)
        for mel, tokens in zip(mels, toks):
            hidden = frozen_hidden(params, cfg, mel, tokens)
            medusa, opt_state, loss = train_medusa_step(
                medusa, opt_state, tx, params, cfg, hidden, tokens, eot
            )
        prev, step = step, step + n
        if step % args.log_every < n or prev == 0:
            print(
                f"step {step}/{args.steps}: head loss {float(loss):.4f} "
                f"({(time.time() - t0) / step:.2f} s/step)",
                flush=True,
            )
        if args.save_every and step % args.save_every < n:
            save_medusa(args.output + ".partial", medusa)

    save_medusa(args.output, medusa)
    print(f"saved {args.n_heads} heads -> {args.output}")
    probs = measure_head_accuracy(params, cfg, medusa, dataset, eot,
                                  batch_size=args.batch_size, seed=args.seed)
    write_accuracy(args.output, probs)
    return probs


if __name__ == "__main__":
    main()
