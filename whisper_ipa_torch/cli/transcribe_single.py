"""CLI: one audio file -> IPA with a checkpoint.

Counterpart of ``whisper_ipa_tpu/cli/transcribe_single.py`` (the
reference's scripts/transcribe_single.py, with its hard-coded paths as
arguments of the same defaults), on ``--device``.

  python -m whisper_ipa_torch.cli.transcribe_single --base-model small \\
      --checkpoint run/checkpoint-1000 --audio clip.wav
"""

import argparse

from ..audio import load_audio, log_mel_spectrogram, pad_or_trim
from ..config import get_config
from ..decode import DecodingOptions, decode
from ..models import load_checkpoint_auto
from ..tokenizer import get_tokenizer
from ..train.loop import load_or_init_params, resolve_device
from . import add_device_flag, add_overlay_flags


def transcribe_file(params, cfg, audio_path: str, language: str = "en") -> str:
    """The greedy transcription of one file's first 30 s (host log-mel, as
    the evaluation's data loader computes it)."""
    print(f"Transcribing {audio_path}...")
    audio = pad_or_trim(load_audio(audio_path))
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)[None]
    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual,
        num_languages=cfg.num_languages,
        language=language,
    )
    options = DecodingOptions(language=language, without_timestamps=True)
    result = decode(params, cfg, mel, options, tokenizer=tokenizer)
    return result[0].text.strip()


def main(argv=None) -> str:
    """Run the CLI; returns the transcription."""
    p = argparse.ArgumentParser(description="Transcribe one file to IPA")
    p.add_argument(
        "--checkpoint", type=str, default="checkpoints/whisper-ipa/checkpoint-8000"
    )
    p.add_argument(
        "--base-model", type=str, default="mlx-community/whisper-large-v3-mlx"
    )
    p.add_argument("--audio", type=str, default="4.wav")
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--weights", type=str, default=None)
    add_overlay_flags(p)
    add_device_flag(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.base_model)
    params = load_or_init_params(args.base_model, cfg, args.weights,
                                 device=device)
    params, n_loaded = load_checkpoint_auto(
        args.checkpoint, params, args.full_ckpt
    )
    print(f"Loaded {n_loaded} tensors")

    transcription = transcribe_file(params, cfg, args.audio, args.language)
    print("\n" + "=" * 50)
    print(f"Audio: {args.audio}")
    print(f"Prediction: {transcription}")
    print("=" * 50)
    return transcription


if __name__ == "__main__":
    main()
