"""Minimal fine-tuning proof-of-concept on dummy data, through the PyTorch
port.

The port's counterpart of examples/minimal_finetune.py: build the
test-tiny model, run five train steps on one seeded random mel/token
batch, watch the loss fall.

  python examples/torch_minimal_finetune.py [--device cpu | --cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card) or "cpu"')
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)

    import torch

    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.train import create_train_state, train_step
    from whisper_ipa_torch.train.loop import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = CONFIGS["test-tiny"]
    params = init_params(cfg, seed=0, device=dev)
    state, tx = create_train_state(params, learning_rate=1e-3)

    rng = np.random.default_rng(0)
    eot = 50257
    mel = torch.from_numpy(
        rng.standard_normal((2, cfg.n_audio_ctx * 2, cfg.n_mels)).astype(
            np.float32
        )
    ).to(dev)
    tokens = torch.tensor(
        [[50258, 50259, 50359, 50363, 100, 200, eot, eot]] * 2,
        dtype=torch.int32, device=dev,
    )

    losses = []
    for step in range(5):
        state, loss = train_step(state, mel, tokens, cfg, tx, eot)
        losses.append(float(loss))
        print(f"step {step + 1}: loss {losses[-1]:.4f}")
    print("done — loss should be decreasing (overfitting one batch)")
    return losses


if __name__ == "__main__":
    main()
