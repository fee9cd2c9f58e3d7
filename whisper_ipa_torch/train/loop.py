"""The training loop: Whisper IPA fine-tuning.

Counterpart of ``whisper_ipa_tpu/train/loop.py``, with the same printed
lines, files (training_config.json, training_log.csv, validation_log.csv,
checkpoint-N/, best-checkpoint/, training_summary.json), resume and
best-checkpoint logic. It runs on ``device`` ("cuda" by default; pass
"cpu" explicitly to train on the CPU).

Several devices: every process of a ``torch.distributed`` world (one a
device, ``parallel.initialize``) runs ``train`` with the same arguments.
The mesh is data x ``tensor_parallel`` over the world; each data rank
reads its block of the training set and feeds ``batch_size // data``
rows a step (the ranks of one tensor-parallel group read the same rows),
and ``train.step.make_zero1_step`` runs DP, ZeRO-1 or FSDP, each with or
without Megatron TP. Rank 0 writes the files; checkpoints gather to it.
Validation decodes each data rank's rows and gathers the texts.

``cache_encoder`` encodes with the run's placement: TP blocks through
``encode(..., tp=)``, FSDP slices gathered first, each data rank its own
rows. Resume reads each rank's latest checkpoint; when the ranks' steps
differ (no shared filesystem), every rank takes rank 0's restored state
and cuts its own blocks, as the reference broadcasts process 0's.

The steps run in chunks (``train.step.train_chunk``, or
``make_zero1_step(chunk=True)`` over a mesh) of up to ``steps_per_call``
C: a power of two of at most C steps that never crosses a validation, a
save, the profiler's marks or the end of the run (``_chunk_len``), its
batches stacked with EOT padding to the widest (``train.chunking``) and
uploaded once from pinned memory. C = 1 is one step a chunk. The host waits for the device once a
chunk, and reads the losses of the steps it logs in one copy. Ranks of
one host chunk their local rows, as the reference's one-host mesh does;
across hosts the reference uses 1, and so does the port.

Unlike the reference, nothing swallows an error: ``validate`` lets a
decode error propagate, and a failed step still writes the emergency
checkpoint (one rank only) but then re-raises (on the card either would
otherwise hide a kernel fault). The logged step time waits for the
device: a chunk's wall over its steps.
"""

from __future__ import annotations

import gc
import json
import os
import time
from datetime import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import WhisperConfig, get_config
from ..data.dataset import IPADataset, PrefetchLoader, create_data_loader
from ..decode import DecodingOptions, decode
from ..metrics import evaluate_batch
from ..models import init_params
from ..models.convert import (
    cast_tree_dtype,
    flatten_params,
    unflatten_params,
    load_safetensors_flat,
    params_from_flat,
)
from ..models.whisper import count_parameters
from ..parallel import distributed as D
from ..parallel.mesh import (
    fsdp_param_shardings,
    gather_rows,
    make_mesh,
    opt_state_shardings,
    param_shardings,
    place_params,
    replicate,
    shard_padded_batch,
    shard_params,
)
from .checkpoints import (
    broadcast_checkpoint,
    check_vocab_provenance,
    latest_checkpoint,
    place_checkpoint,
    read_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
)
from .chunking import pow2_floor, stack_pad_batches
from .logger import (
    TrainingLogger,
    console_step_line,
    get_hardware_info,
    save_training_config,
)
from .optimizer import make_schedule
from .step import (
    ShardedLayout,
    create_train_state,
    create_train_state_zero1,
    make_zero1_step,
    train_chunk,
)


def resolve_device(device) -> torch.device:
    """The device to run on; "cuda" without a card raises (no silent
    CPU). Training, the service and the inference CLIs share it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is false; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def validate(
    params,
    cfg: WhisperConfig,
    dataset: IPADataset,
    tokenizer,
    num_samples: int = 100,
    val_batch_size: int = 8,
    mesh=None,
) -> Dict:
    """Decode a test subset (language detected per row) and score PER/PFER.

    mesh: shard each decode batch over the mesh 'data' axis (every rank of
    the world calls this; params replicated, or TP blocks decoded with
    ``mesh.tp``). Tail batches zero-pad to a multiple of the data axis;
    the texts are gathered in row order and the pad rows dropped."""
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
        mel, n_real = shard_padded_batch(mesh, batch["mel_features"])
        results = decode(
            params, cfg, mel, options, tokenizer=tokenizer,
            tp=mesh.tp if mesh is not None else None,
        )
        texts = gather_rows(mesh, [r.text.strip() for r in results], n_real)
        hypotheses.extend(texts)
        references.extend(t.strip() for t in batch["ipa_texts"])
        if start == 0:
            print("\nSample Predictions:")
            for k in range(min(3, len(texts))):
                print(f"  Ref:  [{references[k]}]")
                print(f"  Pred: [{hypotheses[k]}]")
                print("-" * 30)

    metrics = evaluate_batch(references, hypotheses)
    print("Validation Results:")
    print(f"  PER:  {metrics['per']:.2f}%")
    print(f"  PFER: {metrics['pfer']:.2f}%")
    return metrics


def _chunk_len(step: int, num_steps: int, steps_per_call: int,
               validate_every: int = 0, save_every: int = 0,
               profile_start: Optional[int] = None) -> int:
    """Steps in the chunk that starts after ``step``: a power of two of at
    most ``steps_per_call`` that crosses no validation, no save, no
    profiler mark and not the end of the run. The profiler (on when
    ``profile_start`` is the run's first step) starts before the chunk
    that starts at profile_start + 9 and stops after the one that ends at
    profile_start + 15."""
    left = num_steps - step
    for period in (validate_every, save_every):
        if period:
            left = min(left, period - step % period)
    if profile_start is not None:
        for mark in (profile_start + 9, profile_start + 15):
            if step < mark:
                left = min(left, mark - step)
    return pow2_floor(min(steps_per_call, left))


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
    """Main training entry point (the reference's surface).

    Every rank of a process group calls it (see the module docstring);
    one process trains alone. ``profile_dir`` writes a ``torch.profiler``
    trace of steps start+10..start+15. ``steps_per_call``: steps a chunk
    (the module docstring).
    """
    dev = resolve_device(device)
    rank, world = (
        (dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
        else (0, 1)
    )
    multi = world > 1
    is_main = rank == 0
    if multi and dev.type == D.default_device().type:
        dev = D.default_device()  # the rank's own card
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
    if is_main:
        save_training_config(output_dir, args_dict, get_hardware_info())
    logger = TrainingLogger(output_dir, write_files=is_main)

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

    # the mesh and the parameters' placement come before the optimizer
    # state: ZeRO-1 creates its moments as each rank's slice
    if tensor_parallel > 1 and world > int(
            os.environ.get("LOCAL_WORLD_SIZE", world)):
        raise ValueError(
            "tensor_parallel > 1 in the training loop is single-host for "
            "now: the multi-host global-batch assembly assumes a pure-DP "
            "device order"
        )
    mesh = (
        make_mesh(
            # --no-data-parallel with TP: a pure-model mesh (data=1),
            # not an implicit data axis over the remaining devices
            data=(1 if (not data_parallel and tensor_parallel > 1) else None),
            model=tensor_parallel,
        )
        if (data_parallel or multi or tensor_parallel > 1)
        else None
    )
    n_data = int(mesh.shape["data"]) if mesh is not None else 1
    if mesh is not None:
        if tensor_parallel > 1:
            print(
                f"Mesh over {mesh.size} device(s): data={n_data} x "
                f"model={tensor_parallel} (Megatron TP"
                + (" + DP" if n_data > 1 else "") + ")"
            )
        else:
            print(f"Data-parallel over {mesh.size} device(s): {mesh}")
        # the batch shards over 'data' only — round to the data axis
        if batch_size % n_data != 0:
            batch_size = max(n_data, (batch_size // n_data) * n_data)
            print(f"  (batch size rounded to {batch_size} for even sharding)")
    use_tp = tensor_parallel > 1 and mesh is not None
    use_fsdp = fsdp and mesh is not None and n_data > 1
    if fsdp and not use_fsdp:
        print("FSDP requested but no data-parallel mesh axis; ignoring")
    use_zero1 = (zero1 or use_fsdp) and mesh is not None and n_data > 1
    if zero1 and not use_zero1:
        print("ZeRO-1 requested but no data-parallel mesh axis; ignoring")
    param_sh = None
    if use_fsdp:
        param_sh = fsdp_param_shardings(mesh, params, tensor_parallel=use_tp)
        params = place_params(replicate(mesh, params), param_sh)
    elif use_tp:
        params = shard_params(mesh, params, tensor_parallel=True)
        param_sh = param_shardings(mesh, params)
    elif mesh is not None:
        params = replicate(mesh, params)

    train_kw = dict(
        learning_rate=learning_rate,
        freeze_encoder=freeze_encoder,
        schedule=schedule if use_schedule else None,
        accum_steps=accum_steps,
        mu_dtype=mu_dtype,
    )
    if use_zero1:
        state, tx, opt_sh = create_train_state_zero1(
            mesh, params, tensor_parallel=use_tp, **train_kw
        )
    else:
        state, tx = create_train_state(params, **train_kw)
        if mesh is not None:
            opt_sh = opt_state_shardings(mesh, tx, params,
                                         tensor_parallel=use_tp, zero1=False)
    if mesh is not None:
        state.layout = ShardedLayout(
            mesh,
            flatten_params(param_sh if param_sh is not None
                           else param_shardings(mesh, params, rules=())),
            opt_sh,
        )
        if use_fsdp:
            print(
                f"FSDP (ZeRO-3): parameters AND optimizer state sharded "
                f"over data={n_data} (~1/{n_data} of weights + moments per "
                "device; each layer all-gathered where it runs, gradients "
                "reduce-scattered)"
            )
        elif use_zero1:
            print(
                f"ZeRO-1: optimizer state sharded over data={n_data} (~1/"
                f"{n_data} of the AdamW moments per device)"
            )
        if use_tp:
            print(
                f"Tensor parallel: Megatron param sharding over "
                f"model={tensor_parallel}"
            )

    def lr_at(s: int) -> float:
        """The lr actually applied at step s (schedule-aware logging)."""
        return float(schedule(s)) if use_schedule else learning_rate

    resumed_ckpt = None
    restored = None
    if resume:
        ckpt = latest_checkpoint(output_dir)
        if ckpt:
            restored, _ = read_checkpoint(ckpt, state)
            resumed_ckpt = ckpt
            print(f"Resumed from {ckpt} at step {restored['step']}")
    if multi and resume:
        # rank 0 writes the checkpoints; without a shared filesystem the
        # other ranks find none (or an older one) and would start apart
        # from it. Rank 0 is authoritative, as process 0 in the
        # reference: when the resumed steps differ, every rank takes its
        # restored state (the whole host tree; each rank cuts its blocks)
        steps = D.all_gather_object(
            restored["step"] if restored else int(state.step))
        if len(set(steps)) != 1:
            print(
                f"Resume steps disagree across ranks ({sorted(steps)}); "
                "broadcasting rank 0's restored state (no shared "
                "filesystem?)"
            )
            restored = broadcast_checkpoint(restored if is_main else None)
            if not is_main:
                resumed_ckpt = None  # rank 0 checks the vocabulary
    if restored is not None:
        state = place_checkpoint(restored, state)
        del restored

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

    shard = None
    if n_data > 1:
        # each data rank reads its block of the training set; the ranks
        # of one tensor-parallel group read the same rows
        shard = D.local_shard_indices(len(train_dataset), mesh.data_rank,
                                      n_data)
    if cache_encoder:
        print("\nPrecomputing frozen-encoder features...")
        encoder = state.params
        if use_fsdp:
            # the frozen encoder's FSDP slices gathered once (a collective
            # over 'data'), TP blocks kept: the one-rank run's features
            encoder = {"encoder": unflatten_params({
                n: state.layout.params["encoder." + n].gather(
                    t, axes=("data",))
                for n, t in flatten_params(state.params["encoder"]).items()
            })}
        n_new = train_dataset.precompute_features(
            encoder, cfg, os.path.join(output_dir, "encoder_cache"),
            dtype_name=compute_dtype, mesh=mesh, rows=shard,
        )
        del encoder
        print(f"Encoder cache ready ({n_new} newly encoded)")

    if shard is not None:
        train_dataset.data = [train_dataset.data[i] for i in shard]
        print(
            f"Data rank {mesh.data_rank}/{n_data}: "
            f"{len(train_dataset.data)} local training samples"
        )

    print("\n" + "=" * 70)
    print(f"Starting training for {num_steps} steps")
    print("=" * 70)

    start_time = time.time()
    start_step = int(state.step)
    latest_loss = None
    eot = tokenizer.eot
    knobs = dict(
        freeze_encoder=freeze_encoder,
        dtype_name=compute_dtype,
        remat=remat,
        blockwise=blockwise_loss,
        inputs_are_features=cache_encoder,
        bf16_head=bf16_head,
    )
    if mesh is not None:
        chunk_fn = make_zero1_step(mesh, cfg, tx, eot, opt_sh,
                                   param_shardings=param_sh, chunk=True,
                                   **knobs)

        def run_steps(st, mels, toks):
            return chunk_fn(st, mels, toks)
    else:
        def run_steps(st, mels, toks):
            return train_chunk(st, mels, toks, cfg, tx, eot, **knobs)

    if steps_per_call > 1 and world > int(
            os.environ.get("LOCAL_WORLD_SIZE", world)):
        # ranks of one host chunk their local rows (the reference's
        # one-host mesh); across hosts the reference takes one step a call
        print("steps_per_call > 1 is single-host only; using 1")
        steps_per_call = 1
    loader = PrefetchLoader(
        train_dataset,
        batch_size // n_data,
        num_steps - start_step,
        seed=seed + start_step,
        fixed_token_len=fixed_token_len,
        # a chunk drains steps_per_call batches at once: the worker keeps
        # a whole chunk ready ahead of it
        depth=max(2, 2 * steps_per_call),
    )
    bf16 = compute_dtype == "bfloat16"
    profiler = None

    def decode_params():
        """The parameters decoding takes: FSDP slices gathered (a
        collective), TP blocks as they are."""
        if not use_fsdp:
            return state.params
        return unflatten_params({
            n: state.layout.params[n].gather(t, axes=("data",))
            for n, t in flatten_params(state.params).items()
        })

    def upload(batches):
        """The chunk's (C, B, ...) stack on the device (C = 1 for one step).
        bf16 training casts the mels on the host (round to nearest even):
        both consumers cast at entry anyway, so this only halves the
        bytes."""
        mel, tokens = stack_pad_batches(batches, eot, bf16_mels=bf16)
        if dev.type == "cuda":
            mel, tokens = mel.pin_memory(), tokens.pin_memory()
        return (mel.to(dev, non_blocking=True),
                tokens.to(dev, non_blocking=True).long())

    def run_chunk(batches, step, profiler):
        """One chunk of len(batches) steps, its logging, validation and
        saving; returns (step, latest loss, the profiler while it runs)."""
        nonlocal state
        n = len(batches)
        step_start = time.time()
        mel, tokens = upload(batches)
        if profile_dir and step + 1 == start_step + 10:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if dev.type == "cuda" else []),
            )
            profiler.start()
        state, losses = run_steps(state, mel, tokens)
        prev, step = step, step + n
        if profiler is not None and prev < start_step + 15 <= step:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(profile_dir, "trace.json")
            )
            profiler = None
        latest = losses[-1]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_time = (time.time() - step_start) / n

        logged = [s for s in range(prev + 1, step + 1)
                  if s % 10 == 0 or s <= 5]
        if logged:
            # the chunk's losses in one device-to-host copy
            host = losses.tolist()
            latest = host[-1]
            for s in logged:
                print(console_step_line(s, num_steps, host[s - prev - 1],
                                        step_time, batch_size))
                logger.log_train_step(
                    s, host[s - prev - 1], lr_at(s), step_time, batch_size,
                    time.time() - start_time,
                )
        if step % 200 < n:
            gc.collect()

        if validate_every and step % validate_every == 0:
            metrics = validate(
                decode_params(), cfg, test_dataset, tokenizer,
                num_samples=100, mesh=mesh,
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
        batch_iter = iter(loader)
        while step < num_steps:
            batches = []
            for _ in range(_chunk_len(
                    step, num_steps, steps_per_call, validate_every,
                    save_every, start_step if profile_dir else None)):
                nxt = next(batch_iter, None)
                if nxt is None:
                    break
                batches.append(nxt)
            if not batches:
                break
            try:
                step, latest_loss, profiler = run_chunk(batches, step,
                                                        profiler)
            except Exception as e:
                # the steps of the chunk that completed are applied in
                # place: label the checkpoint with what the state holds
                step = int(state.step)
                print(f"\nError at step {step}: {e}")
                if multi:
                    raise  # a checkpoint is a collective the others miss
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
            decode_params(), cfg, test_dataset, tokenizer,
            num_samples=min(final_validate_samples, len(test_dataset)),
            mesh=mesh,
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
        if is_main:
            with open(os.path.join(output_dir, "training_summary.json"),
                      "w") as f:
                json.dump(summary, f, indent=2)
        print(f"\nTraining complete in {total_time / 60:.1f} minutes")
        print(f"  Final loss: {latest_loss:.4f}")
        print(f"  Final PER: {metrics['per']:.2f}%")
        print(f"  Final PFER: {metrics['pfer']:.2f}%")
    return summary
