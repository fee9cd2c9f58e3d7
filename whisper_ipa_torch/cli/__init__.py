"""Command-line entry points of the PyTorch package
(``python -m whisper_ipa_torch.cli.<name>``):

  train_whisper_ipa   fine-tuning loop
  evaluate_model      checkpoint evaluation (PER/PFER), base-model comparison
  transcribe_single   one file -> IPA with a checkpoint
  transcribe          audio files of any length -> text or JSON (30 s windows)
  evaluate_ipa        metric self-test (host only)
  error_analysis      phone confusions and PER/PFER distributions of a
                      checkpoint on a split (or of saved predictions)
  serve               HTTP server over the micro-batching service
  convert_weights     HF / MLX safetensors -> the checkpoint format
  profile_serving     device time of the serving variants (torch.profiler)

The model CLIs take ``--device`` ("cuda" by default; "cuda" without a card
raises, and ``--device cpu`` runs on the CPU).
"""


def add_overlay_flags(parser):
    """--full-checkpoint / --decoder-only on checkpoint-loading CLIs.

    Default (neither flag) reads the run's training_config.json
    (``models.convert.checkpoint_overlay_mode``): full-fine-tune
    checkpoints get the full overlay, frozen-encoder checkpoints keep the
    decoder-only contract.
    """
    g = parser.add_mutually_exclusive_group()
    g.add_argument(
        "--full-checkpoint", dest="full_ckpt", action="store_true",
        default=None,
        help="overlay ALL tensors (encoder included) - for checkpoints "
        "from full fine-tunes (freeze_encoder=false); default: auto",
    )
    g.add_argument(
        "--decoder-only", dest="full_ckpt", action="store_false",
        help="force the decoder-only reference overlay contract",
    )
    return parser


def add_device_flag(parser):
    """--device: where the model runs ("cuda" unless told otherwise)."""
    parser.add_argument(
        "--device", default="cuda",
        help='"cuda" (default; raises without a card), "cuda:N" or "cpu"',
    )
    return parser
