"""CLI: transcribe audio files of any length (30 s windows, batched).

Counterpart of ``whisper_ipa_tpu/cli/transcribe.py`` over
``decode.transcribe`` on ``--device``: each file is cut into 30 s windows
that decode as one batch, with the temperature-fallback ladder; prints
text or one JSON line a file. ``--bf16`` decodes in bfloat16 (``fp16``).

  python -m whisper_ipa_torch.cli.transcribe --model small \\
      --checkpoint run/checkpoint-1000 --json clip.wav long.wav
"""

import argparse
import json

from ..config import get_config
from ..decode import transcribe
from ..models import load_checkpoint_auto
from ..train.loop import load_or_init_params, resolve_device
from . import add_device_flag, add_overlay_flags


def main(argv=None):
    p = argparse.ArgumentParser(description="Transcribe audio to IPA/text")
    p.add_argument("audio", nargs="+", help="Audio file(s)")
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--language", default="en")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--json", action="store_true", help="Emit JSON per file")
    add_overlay_flags(p)
    add_device_flag(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights, device=device)
    if args.checkpoint:
        params, n = load_checkpoint_auto(
            args.checkpoint, params, args.full_ckpt
        )
        print(f"# loaded {n} tensors from {args.checkpoint}")

    for path in args.audio:
        result = transcribe(
            params,
            cfg,
            path,
            language=args.language,
            temperature=args.temperature,
            beam_size=args.beam_size,
            fp16=args.bf16,
        )
        if args.json:
            print(json.dumps({"file": path, **result}, ensure_ascii=False))
        else:
            print(f"{path}\t{result['text']}")


if __name__ == "__main__":
    main()
