"""CLI: distill a speculative-decoding draft model from a fine-tuned target.

Counterpart of ``whisper_ipa_tpu/cli/distill_draft.py``. Acceptance
measures draft-target agreement, so the draft learns the target's
distribution: a student trains its whole tree (encoder included, bf16
activations) against a frozen teacher checkpoint with
``train.loss.compute_distill_loss`` ((1 - alpha) CE + alpha T^2 KL),
per-tensor clipping at 1.0 and AdamW with ``optax.adamw``'s default weight
decay 1e-4, on token rows padded or cut to a fixed ``--token-len``. It
writes standard checkpoints and a ``training_config.json`` that records
``freeze_encoder: false``, so ``cli.serve --draft-checkpoint`` (through
``load_checkpoint_auto``) overlays every tensor, the trained encoder too.
``--steps-per-call`` C runs the steps in chunks of up to C (a power of two
that crosses no save): the chunk's batches are drawn, stacked with bf16
mels and uploaded at once, and the host reads the loss once a chunk.

  python -m whisper_ipa_torch.cli.distill_draft \\
      --student tiny --teacher small \\
      --teacher-checkpoint ckpts/best-checkpoint --full-checkpoint \\
      --train-data data/train_ipa.json --steps 2000 \\
      --output-dir ckpts/draft-tiny
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distill a speculative-decoding draft model"
    )
    p.add_argument("--student", default="tiny")
    p.add_argument("--teacher", default="small")
    p.add_argument("--teacher-checkpoint", required=True)
    p.add_argument(
        "--full-checkpoint", action="store_true",
        help="overlay ALL teacher tensors (encoder included): required for "
        "checkpoints of full fine-tunes",
    )
    p.add_argument("--student-checkpoint", default=None,
                   help="warm-start the student from a checkpoint")
    p.add_argument("--train-data", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--alpha", type=float, default=0.7,
                   help="KL weight (1-alpha on data CE)")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--language", default="en")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--token-len", type=int, default=128,
                   help="fixed token width of every batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--steps-per-call", type=int, default=8,
        help="steps a chunk (never across a save): the chunk's batches "
        "stacked and uploaded at once, the same batches and step math as "
        "one at a time",
    )
    add_device_flag(p)
    return p


def pad_tokens(tok: np.ndarray, token_len: int, eot: int) -> np.ndarray:
    """EOT-pad or cut the token rows to ``token_len`` (a cut row keeps a
    terminal EOT)."""
    if tok.shape[1] >= token_len:
        out = tok[:, :token_len].copy()
        out[:, -1] = eot
        return out
    pad = np.full((tok.shape[0], token_len - tok.shape[1]), eot, np.int32)
    return np.concatenate([tok, pad], axis=1)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..config import get_config
    from ..data.dataset import create_data_loader
    from ..models import flatten_params, load_checkpoint_model
    from ..ops.precision import full_fp32
    from ..train.checkpoints import save_checkpoint
    from ..train.chunking import pow2_floor, stack_pad_batches
    from ..train.loop import load_or_init_params, resolve_device
    from ..train.loss import compute_distill_loss
    from ..train.optimizer import Optimizer
    from ..train.step import TrainState

    device = resolve_device(args.device)
    s_cfg = get_config(args.student)
    t_cfg = get_config(args.teacher)
    if s_cfg.n_mels != t_cfg.n_mels:
        raise SystemExit(
            "student and teacher must share the mel size "
            f"({s_cfg.n_mels} vs {t_cfg.n_mels})"
        )

    teacher = load_or_init_params(args.teacher, t_cfg, None, device=device)
    teacher, n = load_checkpoint_model(
        args.teacher_checkpoint, teacher, full=args.full_checkpoint
    )
    print(f"Teacher: {n} tensors from {args.teacher_checkpoint}")
    student = load_or_init_params(args.student, s_cfg, None, device=device)
    if args.student_checkpoint:
        student, n = load_checkpoint_model(
            args.student_checkpoint, student, full=True
        )
        print(f"Student warm start: {n} tensors")

    dataset = create_data_loader(
        args.train_data,
        multilingual=s_cfg.multilingual,
        n_mels=s_cfg.n_mels,
        language=args.language,
        mel_cache_dir=args.mel_cache_dir,
    )
    print(f"{len(dataset)} training samples")
    eot = dataset.tokenizer.eot

    # the student trains its whole tree, so every consumer takes the full
    # overlay (checkpoint_overlay_mode reads this file)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "training_config.json"), "w") as f:
        json.dump(
            {
                "training_args": {
                    "freeze_encoder": False,
                    "distilled_from": args.teacher_checkpoint,
                    "teacher_model": args.teacher,
                    "student_model": args.student,
                    "steps": args.steps,
                    "batch_size": args.batch_size,
                    "learning_rate": args.learning_rate,
                }
            },
            f,
            indent=2,
        )

    # optax.chain(clip_by_per_tensor_norm(1.0), optax.adamw(lr))
    tx = Optimizer(learning_rate=args.learning_rate, max_grad_norm=1.0,
                   weight_decay=1e-4, freeze_encoder=False)
    flat = flatten_params(student)
    names = list(flat)
    state = TrainState(step=0, params=student, opt_state=tx.init(flat))

    def step(mel, tokens):
        """One update of the student on one batch; its loss on the device."""
        leaves = [flat[n] for n in names]
        for t in leaves:
            t.requires_grad_(True)
        try:
            with full_fp32():
                loss = compute_distill_loss(
                    student, teacher, s_cfg, t_cfg, mel, tokens, eot,
                    alpha=args.alpha, temperature=args.temperature,
                    dtype=torch.bfloat16,
                )
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        tx.step(flat, {
            n: torch.zeros_like(t) if g is None else g
            for n, t, g in zip(names, leaves, grads)
        }, state.opt_state)
        state.step += 1
        return loss.detach()

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    loss = None
    i = 0
    spc = max(1, args.steps_per_call)
    while i < args.steps:
        n = args.steps - i
        if args.save_every:
            n = min(n, args.save_every - i % args.save_every)
        n = pow2_floor(min(n, spc))
        batches = []
        for _ in range(n):
            idx = rng.choice(len(dataset), args.batch_size,
                             replace=args.batch_size > len(dataset))
            b = dataset.get_batch(idx.tolist())
            b["tokens"] = pad_tokens(np.asarray(b["tokens"]), args.token_len,
                                     eot)
            batches.append(b)
        # bf16 mels: the bf16 forwards cast them at entry anyway
        mels, toks = stack_pad_batches(batches, eot, bf16_mels=True)
        for mel, tokens in zip(mels.to(device), toks.long().to(device)):
            loss = step(mel, tokens)
        prev, i = i, i + n
        if i % args.log_every < n or prev == 0:
            print(
                f"step {i}/{args.steps}: distill loss {float(loss):.4f} "
                f"({(time.time() - t0) / i:.2f} s/step)",
                flush=True,
            )
        if args.save_every and i % args.save_every == 0:
            save_checkpoint(state, i, float(loss), args.output_dir,
                            save_opt_state=False)

    path = save_checkpoint(
        state, args.steps, float(loss) if loss is not None else None,
        args.output_dir, save_opt_state=False,
    )
    print(f"Distilled draft saved -> {path}")
    return path


if __name__ == "__main__":
    main()
