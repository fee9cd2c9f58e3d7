"""CLI: convert Whisper weights between HF and MLX safetensors layouts.

Counterpart of ``whisper_ipa_tpu/cli/convert_weights.py``: brings
openai/whisper checkpoints (HF transformers layout) or mlx-community
exports into the checkpoint format both packages load (MLX names,
reference-compatible layouts), with an optional structural check. Host
only; it reads and writes safetensors with the in-tree reader.

  python -m whisper_ipa_torch.cli.convert_weights \\
      --input model.safetensors --model small --output small.safetensors
"""

import argparse

from ..config import get_config
from ..models import (
    flatten_params,
    init_params,
    load_safetensors_flat,
    params_from_flat,
    save_safetensors,
)
from ..models.convert import detect_format


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert Whisper weight layouts")
    p.add_argument("--input", required=True, help="Source .safetensors")
    p.add_argument("--model", required=True, help="Model size (e.g. small)")
    p.add_argument("--output", required=True, help="Destination .safetensors")
    p.add_argument(
        "--verify",
        action="store_true",
        help="Cross-check tensor shapes against a random-init tree",
    )
    args = p.parse_args(argv)

    flat = load_safetensors_flat(args.input)
    fmt = detect_format(flat)
    print(f"Detected source format: {fmt} ({len(flat)} tensors)")

    params = params_from_flat(flat, fmt=fmt)

    cfg = get_config(args.model)
    if args.verify:
        expected = flatten_params(init_params(cfg, seed=0))
        got = flatten_params(params)
        missing = sorted(set(expected) - set(got))
        extra = sorted(set(got) - set(expected))
        mismatched = [
            k
            for k in set(expected) & set(got)
            if tuple(expected[k].shape) != tuple(got[k].shape)
        ]
        if missing:
            print(f"MISSING ({len(missing)}): {missing[:8]}...")
        if extra:
            print(f"EXTRA ({len(extra)}): {extra[:8]}...")
        if mismatched:
            print(f"SHAPE MISMATCH: {mismatched[:8]}")
        if not (missing or extra or mismatched):
            print("Verification passed: structure matches", cfg.name)
        elif missing or mismatched:
            raise SystemExit(1)

    save_safetensors(args.output, params)
    print(f"Wrote {args.output} (MLX-named, reference-compatible layout)")


if __name__ == "__main__":
    main()
