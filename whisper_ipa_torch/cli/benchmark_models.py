"""CLI: model-size benchmarks — params, throughput, memory estimates.

(reference scripts/experimental/benchmark_models.py /
benchmark_models_simple.py: reference-measured whisper-small decoder
153,580,800 trainable params, ~17 samples/s train throughput on M3 Ultra.)
Counterpart of ``whisper_ipa_tpu/cli/benchmark_models.py`` on one device:
the parameter counts of each model and, with ``--measure``, the time of the
port's training step (frozen encoder, float32 activations) on seeded
inputs, with its MFU over the card's bf16 peak (``utils.flops``; None where
the card is not in the table or the device is the CPU).

  python -m whisper_ipa_torch.cli.benchmark_models --models tiny small \\
      --measure --batch-size 8
"""

import argparse
import time

import numpy as np
import torch

from . import add_device_flag


def analyze_model(name: str, measure: bool = False, batch_size: int = 8,
                  device="cuda"):
    from ..config import get_config
    from ..models import init_params
    from ..models.whisper import count_parameters
    from ..train import create_train_state, train_step
    from ..train.loop import resolve_device

    device = resolve_device(device)
    cfg = get_config(name)
    params = init_params(cfg, seed=0, device=device)
    n_enc = count_parameters(params["encoder"])
    n_dec = count_parameters(params["decoder"])
    report = {
        "model": name,
        "n_mels": cfg.n_mels,
        "d_model": cfg.n_audio_state,
        "layers": cfg.n_audio_layer,
        "encoder_params": n_enc,
        "decoder_params": n_dec,
        "total_params": n_enc + n_dec,
        "fp32_weights_mb": (n_enc + n_dec) * 4 / 1e6,
    }
    print(
        f"{name:>10}: enc {n_enc:>12,}  dec {n_dec:>12,}  "
        f"total {n_enc + n_dec:>12,}  ({report['fp32_weights_mb']:.0f} MB fp32)"
    )

    if measure:
        rng = np.random.default_rng(0)
        mel = torch.from_numpy(
            rng.standard_normal((batch_size, 3000, cfg.n_mels)).astype(
                np.float32
            )
        ).to(device)
        eot = 50257
        tokens = torch.from_numpy(
            np.tile(
                [[50258, 50259, 50359, 50363] + [100] * 27 + [eot]],
                (batch_size, 1),
            ).astype(np.int64)
        ).to(device)
        state, tx = create_train_state(params, learning_rate=1e-5)
        state, loss = train_step(state, mel, tokens, cfg, tx, eot)  # warm-up
        float(loss)  # the host read waits for the device
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            state, loss = train_step(state, mel, tokens, cfg, tx, eot)
        float(loss)
        dt = (time.perf_counter() - t0) / iters
        report["train_step_sec"] = dt
        report["train_samples_per_sec"] = batch_size / dt

        from ..utils.flops import peak_flops, train_step_flops

        flops = train_step_flops(cfg, tokens.shape[1]) * batch_size
        peak = (peak_flops(torch.cuda.get_device_name(device))
                if device.type == "cuda" else None)
        mfu_str = ""
        if peak:
            report["train_mfu"] = flops / dt / peak
            mfu_str = f", MFU {100 * report['train_mfu']:.1f}%"
        print(
            f"{'':>10}  train step {dt * 1e3:.1f} ms -> "
            f"{batch_size / dt:.1f} samples/s (batch {batch_size}{mfu_str}, "
            f"{device})"
        )
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="Model family benchmarks")
    p.add_argument(
        "--models",
        nargs="+",
        default=["tiny", "base", "small", "medium"],
    )
    p.add_argument(
        "--measure", action="store_true", help="Measure train-step throughput"
    )
    p.add_argument("--batch-size", type=int, default=8)
    add_device_flag(p)
    args = p.parse_args(argv)
    return [
        analyze_model(name, measure=args.measure, batch_size=args.batch_size,
                      device=args.device)
        for name in args.models
    ]


if __name__ == "__main__":
    main()
