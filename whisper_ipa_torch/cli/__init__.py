"""Command-line entry points of the PyTorch package
(``python -m whisper_ipa_torch.cli.<name>``):

  train_whisper_ipa   fine-tuning loop
  evaluate_model      checkpoint evaluation (PER/PFER), base-model comparison
  transcribe_single   one file -> IPA with a checkpoint
  transcribe          audio files of any length -> text or JSON (30 s windows)
  evaluate_ipa        metric self-test (host only)
  error_analysis      phone confusions and PER/PFER distributions of a
                      checkpoint on a split (or of saved predictions)
  serve               HTTP server over the micro-batching service or the
                      in-flight engine; speculative decoding with
                      --draft-model <name>|ngram|medusa
  train_medusa        Medusa draft heads on a frozen model (and their
                      per-head accuracy file)
  distill_draft       a draft model distilled from a fine-tuned target
  convert_weights     HF / MLX safetensors -> the checkpoint format
  profile_serving     device time of the serving variants (torch.profiler)
  evaluate_zeroshot   zero-shot PER/PFER on the multipa test set
  benchmark_models    parameter counts; --measure: train-step time and MFU
  profile_inference   per-op self-time table of the decode or train step
                      (torch.profiler)
  calculate_real_speed  out-of-process training speed monitor (host only)
  check_vocab         IPA coverage of the tokenizer (host only)
  prepare_datasets    corpus preparation: TIMIT / METU / OGI / CommonVoice /
                      g2p / combine / verify / analyze (host only)
  parse_zeroshot_test the zero-shot test JSON from the annotator sheets
                      (host only)
  compute_iaa         inter-annotator agreement on it (host only)
  bench_decode_kernel the decode cross-attention's plain path against K4
                      (K8 with --int4), ms a token and GB/s
  bench_quant_decode  greedy decode with f32, int8, int4 and int4-kernel
                      (K7) weights

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
