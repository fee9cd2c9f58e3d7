"""whisper_ipa_torch: the PyTorch / CUDA port of whisper_ipa_tpu for Hopper.

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find, and imports ``torch`` but never
``jax`` nor anything of ``whisper_ipa_tpu``: the host modules it needs
(config, audio, tokenizer, metrics, data) are its own copies.

Layout:
  csrc/       hand-written CUDA C++ kernels for sm_90a (built at first use)
  ops/        kernel wrappers, each beside its plain PyTorch version
              (mel_kernel, attention, decode_attention, kv_init,
              quant_matmul, sr_quant) + the nvcc build step (_build)
  models/     Whisper encoder/decoder over a parameter dict tree, int8
              cross-KV cache, the numpy bridge to the canonical names, and
              the checkpoint loader
  decode/     DecodingOptions / decode(): greedy, temperature sampling,
              best-of, timestamp rules and beam search; transcribe() for
              long-form audio; phone timestamps by DTW
  train/      single-device fine-tuning
  cli/        the command-line entry points
  serve.py    micro-batching TranscriptionService
  serve_continuous.py
              the in-flight batching engine (ContinuousBatcher): requests
              join a running decode batch between chunks of steps

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it never falls back from a failed kernel to the plain version.
"""

__version__ = "0.1.0"
