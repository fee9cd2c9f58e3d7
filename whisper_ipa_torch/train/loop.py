"""The training loop: Whisper IPA fine-tuning on one device.

Counterpart of ``whisper_ipa_tpu/train/loop.py`` for a single device, with
the same printed lines, files (training_config.json, training_log.csv,
validation_log.csv, checkpoint-N/, best-checkpoint/,
training_summary.json), resume and best-checkpoint logic. It runs on
``device`` ("cuda" by default; pass "cpu" explicitly to train on the CPU).

Not ported (raise ``NotImplementedError``): the multi-device regimes
(tensor parallelism, ZeRO-1, FSDP, multi-host) and ``steps_per_call`` > 1.
Unlike the reference, nothing swallows an error: ``validate`` lets a
decode error propagate, and a failed step still writes the emergency
checkpoint but then re-raises (on the card either would otherwise hide a
kernel fault). The logged step time waits for the device.
"""

from __future__ import annotations

import gc
import json
import os
import time
from datetime import datetime
from typing import Dict, Optional

import torch

from ..config import WhisperConfig, get_config
from ..data.dataset import IPADataset, PrefetchLoader, create_data_loader
from ..decode import DecodingOptions, decode
from ..metrics import evaluate_batch
from ..models import init_params
from ..models.convert import (
    cast_tree_dtype,
    load_safetensors_flat,
    params_from_flat,
)
from ..models.whisper import count_parameters
from .checkpoints import (
    check_vocab_provenance,
    latest_checkpoint,
    restore_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
)
from .logger import (
    TrainingLogger,
    console_step_line,
    get_hardware_info,
    save_training_config,
)
from .optimizer import make_schedule
from .step import create_train_state, train_step


def resolve_device(device) -> torch.device:
    """The training device; "cuda" without a card raises (no silent CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is false; pass "
            "device='cpu' (--device cpu) to train on the CPU"
        )
    return dev


def validate(
    params,
    cfg: WhisperConfig,
    dataset: IPADataset,
    tokenizer,
    num_samples: int = 100,
    val_batch_size: int = 8,
) -> Dict:
    """Decode a test subset (language detected per row) and score PER/PFER."""
    print(f"\nValidating on {num_samples} samples...")
    num_samples = min(num_samples, len(dataset))
    references = []
    hypotheses = []
    options = DecodingOptions(
        language=None,
        without_timestamps=True,
        length_penalty=1.0,
    )
    for start in range(0, num_samples, val_batch_size):
        indices = list(range(start, min(start + val_batch_size, num_samples)))
        batch = dataset.get_batch(indices)
        results = decode(
            params, cfg, batch["mel_features"], options, tokenizer=tokenizer
        )
        hypotheses.extend(r.text.strip() for r in results)
        references.extend(t.strip() for t in batch["ipa_texts"])
        if start == 0:
            print("\nSample Predictions:")
            for k in range(min(3, len(results))):
                print(f"  Ref:  [{references[k]}]")
                print(f"  Pred: [{hypotheses[k]}]")
                print("-" * 30)

    metrics = evaluate_batch(references, hypotheses)
    print("Validation Results:")
    print(f"  PER:  {metrics['per']:.2f}%")
    print(f"  PFER: {metrics['pfer']:.2f}%")
    return metrics


def load_or_init_params(model_name: str, cfg: WhisperConfig,
                        weights: Optional[str], device=None):
    """Load pretrained weights from a safetensors path, else random init."""
    if weights and os.path.isfile(weights):
        print(f"Loading weights from {weights}")
        return params_from_flat(load_safetensors_flat(weights), device=device)
    candidates = [
        os.environ.get("WHISPER_IPA_TPU_WEIGHTS_DIR", ""),
        os.path.expanduser("~/.cache/whisper_ipa_tpu"),
    ]
    for root in candidates:
        path = os.path.join(root, f"{cfg.name}.safetensors")
        if root and os.path.isfile(path):
            print(f"Loading weights from {path}")
            return params_from_flat(load_safetensors_flat(path), device=device)
    print(
        f"No pretrained weights found for {model_name!r}; "
        "initializing randomly (set --weights or WHISPER_IPA_TPU_WEIGHTS_DIR)"
    )
    return init_params(cfg, seed=0, device=device)


def train(
    model_name: str,
    train_data_path: str,
    test_data_path: str,
    output_dir: str,
    num_steps: int = 1000,
    batch_size: int = 4,
    learning_rate: float = 1e-5,
    validate_every: int = 100,
    save_every: int = 500,
    test_run: bool = False,
    weights: Optional[str] = None,
    resume: bool = False,
    mel_cache_dir: Optional[str] = None,
    data_parallel: bool = True,
    seed: int = 0,
    final_validate: bool = True,
    final_validate_samples: int = 500,
    profile_dir: Optional[str] = None,
    compute_dtype: str = "float32",
    remat: bool = False,
    warmup_steps: int = 0,
    lr_decay: str = "constant",
    accum_steps: int = 1,
    blockwise_loss: bool = False,
    mu_dtype: Optional[str] = None,
    encoder_bf16: bool = False,
    cache_encoder: bool = False,
    freeze_encoder: bool = True,
    bf16_head: bool = False,
    steps_per_call: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
    tensor_parallel: int = 1,
    fixed_token_len: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Main training entry point (the reference's surface, one device).

    ``data_parallel`` is accepted for the reference's surface; with one
    device it changes nothing. ``profile_dir`` writes a
    ``torch.profiler`` trace of steps start+10..start+15.
    """
    if zero1 or fsdp or tensor_parallel > 1:
        raise NotImplementedError(
            "ZeRO-1, FSDP and tensor parallelism need several devices and "
            "are not ported yet (ROADMAP queue 1 item 12)"
        )
    if steps_per_call > 1:
        raise NotImplementedError(
            "steps_per_call > 1 (train_chunk) is not ported: it amortized "
            "a remote-device dispatch (ROADMAP queue 1 item 14)"
        )
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)

    args_dict = {
        "model_name": model_name,
        "train_data_path": train_data_path,
        "test_data_path": test_data_path,
        "num_steps": num_steps,
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "validate_every": validate_every,
        "save_every": save_every,
        "test_run": test_run,
        "resume": resume,
        # load-time contract: freeze_encoder=False checkpoints carry a
        # trained encoder (models.convert.checkpoint_overlay_mode reads it)
        "freeze_encoder": freeze_encoder,
    }
    save_training_config(output_dir, args_dict, get_hardware_info())
    logger = TrainingLogger(output_dir)

    print("=" * 70)
    print(f"Fine-tuning Whisper for IPA Transcription ({dev.type})")
    print("=" * 70)

    cfg = get_config(model_name)
    n_mels = cfg.n_mels
    print(f"\nModel: {model_name} (n_mels={n_mels})")

    params = load_or_init_params(model_name, cfg, weights, device=dev)
    if encoder_bf16 and not freeze_encoder:
        raise ValueError(
            "encoder_bf16 requires freeze_encoder: casting a TRAINED "
            "encoder to bfloat16 would make the optimizer update bf16 "
            "master weights (silent quality loss). Use --bf16 for "
            "bf16 activations with f32 master weights instead."
        )
    if encoder_bf16:
        params["encoder"] = cast_tree_dtype(params["encoder"], torch.bfloat16)
        print("Frozen encoder stored in bfloat16 (halved device residency)")
    if cache_encoder and not freeze_encoder:
        raise ValueError(
            "cache_encoder requires a frozen encoder (cached features "
            "would go stale as the encoder trains)"
        )
    n_dec = count_parameters(params["decoder"])
    n_total = count_parameters(params)
    if freeze_encoder:
        print(
            f"Trainable parameters: {n_dec:,} / {n_total:,} "
            f"({100 * n_dec / n_total:.1f}%) [encoder frozen]"
        )
    else:
        print(
            f"Trainable parameters: {n_total:,} (full fine-tune, "
            "encoder unfrozen)"
        )

    schedule = make_schedule(
        learning_rate,
        warmup_steps=warmup_steps,
        decay=lr_decay,
        total_steps=num_steps,
    )
    use_schedule = bool(warmup_steps) or lr_decay != "constant"
    state, tx = create_train_state(
        params,
        learning_rate=learning_rate,
        freeze_encoder=freeze_encoder,
        schedule=schedule if use_schedule else None,
        accum_steps=accum_steps,
        mu_dtype=mu_dtype,
    )

    def lr_at(s: int) -> float:
        """The lr actually applied at step s (schedule-aware logging)."""
        return float(schedule(s)) if use_schedule else learning_rate

    resumed_ckpt = None
    if resume:
        ckpt = latest_checkpoint(output_dir)
        if ckpt:
            state, _ = restore_checkpoint(ckpt, state)
            resumed_ckpt = ckpt
            print(f"Resumed from {ckpt} at step {int(state.step)}")

    print(f"\nLoading training data: {train_data_path}")
    train_dataset = create_data_loader(
        train_data_path, n_mels=n_mels, mel_cache_dir=mel_cache_dir
    )
    print(f"Loading test data: {test_data_path}")
    test_dataset = create_data_loader(
        test_data_path, n_mels=n_mels, mel_cache_dir=mel_cache_dir
    )
    tokenizer = train_dataset.tokenizer
    if resumed_ckpt:
        check_vocab_provenance(resumed_ckpt, tokenizer, strict=True)

    if test_run:
        print("\nTEST RUN MODE: Using only 100 training samples")
        train_dataset.data = train_dataset.data[:100]
        num_steps = min(num_steps, 100)

    if cache_encoder:
        print("\nPrecomputing frozen-encoder features...")
        n_new = train_dataset.precompute_features(
            state.params, cfg, os.path.join(output_dir, "encoder_cache"),
            dtype_name=compute_dtype,
        )
        print(f"Encoder cache ready ({n_new} newly encoded)")

    print("\n" + "=" * 70)
    print(f"Starting training for {num_steps} steps")
    print("=" * 70)

    start_time = time.time()
    start_step = int(state.step)
    latest_loss = None
    eot = tokenizer.eot
    loader = PrefetchLoader(
        train_dataset,
        batch_size,
        num_steps - start_step,
        seed=seed + start_step,
        fixed_token_len=fixed_token_len,
    )
    mel_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
    profiler = None

    def run_one(batch, step, profiler):
        """One step on one batch, its logging, validation and saving;
        returns (step, latest loss, the profiler while it runs)."""
        nonlocal state
        latest = None
        step_start = time.time()
        # bf16 training casts the mels on the host before the upload:
        # both consumers cast at entry anyway, so this only halves
        # the bytes moved
        mel = torch.from_numpy(batch["mel_features"]).to(
            dev, dtype=mel_dtype, non_blocking=True
        )
        tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
        if profile_dir and step + 1 == start_step + 10:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if dev.type == "cuda" else []),
            )
            profiler.start()
        state, loss = train_step(
            state, mel, tokens, cfg, tx, eot,
            freeze_encoder=freeze_encoder,
            dtype_name=compute_dtype,
            remat=remat,
            blockwise=blockwise_loss,
            inputs_are_features=cache_encoder,
            bf16_head=bf16_head,
        )
        step += 1
        if profiler is not None and step == start_step + 15:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(profile_dir, "trace.json")
            )
            profiler = None
        latest = loss
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_time = time.time() - step_start

        if step % 10 == 0 or step <= 5:
            # reading the loss waits for the device: only when logging
            latest = float(loss)
            print(
                console_step_line(
                    step, num_steps, latest, step_time, batch_size
                )
            )
            logger.log_train_step(
                step, latest, lr_at(step), step_time, batch_size,
                time.time() - start_time,
            )
        if step % 200 == 0:
            gc.collect()

        if validate_every and step % validate_every == 0:
            metrics = validate(
                state.params, cfg, test_dataset, tokenizer, num_samples=100
            )
            if logger.log_validation(step, metrics,
                                     time.time() - start_time):
                save_best_checkpoint(
                    state, step, metrics["pfer"], metrics["per"],
                    output_dir,
                )
                print(
                    f"  New best PFER {metrics['pfer']:.2f}% at step {step}"
                )

        if save_every and step % save_every == 0:
            save_checkpoint(
                state, step, latest, output_dir,
                logger=logger, start_time=start_time,
                learning_rate=learning_rate,
                vocab_provenance=tokenizer.provenance,
            )
        return step, latest, profiler

    try:
        step = start_step
        for batch in loader:
            if step >= num_steps:
                break
            try:
                step, latest_loss, profiler = run_one(batch, step, profiler)
            except Exception as e:
                print(f"\nError at step {step}: {e}")
                save_checkpoint(
                    state, step,
                    float(latest_loss) if latest_loss is not None else None,
                    output_dir, logger=logger, start_time=start_time,
                    learning_rate=learning_rate,
                    vocab_provenance=tokenizer.provenance,
                )
                raise
    finally:
        loader.close()
        if profiler is not None:
            profiler.stop()

    print("\n" + "=" * 70)
    print("Training complete!")
    print("=" * 70)
    if final_validate:
        metrics = validate(
            state.params, cfg, test_dataset, tokenizer,
            num_samples=min(final_validate_samples, len(test_dataset)),
        )
        logger.log_validation(num_steps, metrics, time.time() - start_time)
    else:
        metrics = {"per": float("nan"), "pfer": float("nan")}

    summary = {}
    if latest_loss is not None:
        latest_loss = float(latest_loss)
        print("\nSaving final model...")
        save_checkpoint(
            state, num_steps, latest_loss, output_dir,
            logger=logger, start_time=start_time,
            learning_rate=learning_rate,
            vocab_provenance=tokenizer.provenance,
        )
        total_time = time.time() - start_time
        summary = {
            "total_wall_clock_sec": total_time,
            "total_wall_clock_min": total_time / 60,
            "final_loss": latest_loss,
            "final_per": metrics["per"],
            "final_pfer": metrics["pfer"],
            "best_pfer": (
                logger.best_pfer if logger.best_pfer != float("inf") else None
            ),
            "best_pfer_step": logger.best_pfer_step,
            "end_time": datetime.now().isoformat(),
        }
        with open(os.path.join(output_dir, "training_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(f"\nTraining complete in {total_time / 60:.1f} minutes")
        print(f"  Final loss: {latest_loss:.4f}")
        print(f"  Final PER: {metrics['per']:.2f}%")
        print(f"  Final PFER: {metrics['pfer']:.2f}%")
    return summary
