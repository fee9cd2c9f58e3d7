"""CLI: Whisper IPA fine-tuning (PyTorch).

The flags of ``whisper_ipa_tpu/cli/train_whisper_ipa.py`` plus --device
("cuda" by default, "cpu" to train on the CPU). --steps-per-call C runs
the steps in chunks of up to C (``train.step.train_chunk``): the host
waits for the card once a chunk instead of once a step.

Several devices: launch one process a device with torchrun; each joins the
process group from torchrun's environment (NCCL on cuda, gloo on cpu) and
the mesh is data x --tensor-parallel over the world, with --zero1 / --fsdp
sharding the optimizer state / the parameters over 'data'.

Usage:
  python -m whisper_ipa_torch.cli.train_whisper_ipa \
      --model small --train-data data/processed/combined_train_ipa.json \
      --test-data data/processed/combined_test_ipa.json \
      --output-dir checkpoints/whisper-ipa --steps 10000 --batch-size 12
  torchrun --nproc-per-node 4 -m whisper_ipa_torch.cli.train_whisper_ipa \
      --model small --tensor-parallel 2 --zero1 ...
"""

import argparse
import os

import torch.distributed as dist

from ..parallel import initialize
from ..train.loop import train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fine-tune Whisper for IPA transcription (PyTorch)"
    )
    p.add_argument(
        "--model",
        type=str,
        default="mlx-community/whisper-small-mlx",
        help="Whisper model name (accepts HF/MLX repo ids or plain sizes)",
    )
    p.add_argument(
        "--train-data",
        type=str,
        default="data/processed/english_only_train_ipa.json",
    )
    p.add_argument(
        "--test-data",
        type=str,
        default="data/processed/english_only_test_ipa.json",
    )
    p.add_argument("--output-dir", type=str, default="checkpoints/whisper-ipa")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--validate-every", type=int, default=1000)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument(
        "--test-run", action="store_true", help="Test run with only 100 samples"
    )
    p.add_argument(
        "--weights",
        type=str,
        default=None,
        help="Path to pretrained safetensors (HF or MLX layout)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="Resume from the latest checkpoint in --output-dir",
    )
    p.add_argument("--mel-cache-dir", type=str, default=None)
    p.add_argument("--no-data-parallel", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--bf16",
        action="store_true",
        help="bfloat16 activations (params/optimizer stay float32)",
    )
    p.add_argument(
        "--remat",
        action="store_true",
        help="Rematerialize each layer in the backward (less memory)",
    )
    p.add_argument("--profile-dir", type=str, default=None)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument(
        "--lr-decay", default="constant",
        choices=["constant", "linear", "cosine"],
    )
    p.add_argument(
        "--accum-steps", type=int, default=1,
        help="Gradient accumulation (effective batch = batch * accum)",
    )
    p.add_argument(
        "--blockwise-loss", action="store_true",
        help="Memory-efficient CE (never materializes B*T*51865 logits)",
    )
    p.add_argument("--mu-dtype", default=None, choices=[None, "bfloat16"])
    p.add_argument(
        "--encoder-bf16", action="store_true",
        help="Store the frozen encoder in bfloat16 (halves its memory)",
    )
    p.add_argument(
        "--cache-encoder", action="store_true",
        help="Precompute frozen-encoder outputs once and train on cached "
        "features (~3x step throughput; encoder is frozen anyway)",
    )
    p.add_argument(
        "--bf16-head", action="store_true",
        help="bfloat16 operands (float32 accumulation) in the logits "
        "product",
    )
    p.add_argument(
        "--unfreeze-encoder", action="store_true",
        help="Full fine-tune: train the encoder too (the reference "
        "always freezes it; needed when starting from random weights)",
    )
    p.add_argument(
        "--steps-per-call", type=int, default=1,
        help="Optimizer steps per call (train_chunk: the step's body over "
        "stacked batches, numerically identical). The host waits for the "
        "device once a chunk",
    )
    p.add_argument(
        "--tensor-parallel", type=int, default=1,
        help="Megatron tensor-parallel degree: shard qkv/mlp weights over "
        "the mesh 'model' axis (processes = data x model); single-host",
    )
    p.add_argument(
        "--zero1", action="store_true",
        help="ZeRO-1: shard the optimizer state over the data-parallel "
        "mesh axis (each rank holds 1/dp of the AdamW moments)",
    )
    p.add_argument(
        "--fsdp", action="store_true",
        help="FSDP (ZeRO-3): shard the parameters over the data-parallel "
        "mesh axis too (implies --zero1 moments); each layer's slices are "
        "all-gathered where it runs and their gradients reduce-scattered; "
        "composes with --tensor-parallel",
    )
    p.add_argument(
        "--preset",
        default=None,
        choices=["large-single-chip"],
        help="large-single-chip: remat + bf16 activations/moments + "
        "blockwise CE + bf16 frozen encoder",
    )
    p.add_argument(
        "--device", default="cuda",
        help="Training device: cuda (the default) or cpu",
    )
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        initialize(device=args.device)  # torchrun: one process a device
    if args.preset == "large-single-chip":
        args.remat = True
        args.bf16 = True
        args.blockwise_loss = True
        args.mu_dtype = "bfloat16"
        args.encoder_bf16 = True
    train(
        model_name=args.model,
        train_data_path=args.train_data,
        test_data_path=args.test_data,
        output_dir=args.output_dir,
        num_steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        validate_every=args.validate_every,
        save_every=args.save_every,
        test_run=args.test_run,
        weights=args.weights,
        resume=args.resume,
        mel_cache_dir=args.mel_cache_dir,
        data_parallel=not args.no_data_parallel,
        seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat,
        profile_dir=args.profile_dir,
        warmup_steps=args.warmup_steps,
        lr_decay=args.lr_decay,
        accum_steps=args.accum_steps,
        blockwise_loss=args.blockwise_loss,
        mu_dtype=args.mu_dtype,
        encoder_bf16=args.encoder_bf16,
        cache_encoder=args.cache_encoder,
        freeze_encoder=not args.unfreeze_encoder,
        bf16_head=args.bf16_head,
        steps_per_call=args.steps_per_call,
        zero1=args.zero1,
        fsdp=args.fsdp,
        tensor_parallel=args.tensor_parallel,
        device=args.device,
    )


if __name__ == "__main__":
    main()
