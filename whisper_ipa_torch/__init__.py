"""whisper_ipa_torch: the PyTorch / CUDA port of whisper_ipa_tpu for Hopper.

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find, and imports ``torch`` but never
``jax``. Host modules that hold no JAX (``whisper_ipa_tpu.config``,
``whisper_ipa_tpu.audio``, ``whisper_ipa_tpu.tokenizer``) are reused, not
copied.

Layout:
  csrc/       hand-written CUDA C++ kernels for sm_90a (built at first use)
  ops/        kernel wrappers, each beside its plain PyTorch version
              (mel_kernel, attention, decode_attention) + the nvcc builder
  models/     Whisper encoder/decoder over a parameter dict tree, int8
              cross-KV cache, and the numpy bridge to the canonical names
  decode/     DecodingOptions / decode(): greedy and temperature sampling
  serve.py    micro-batching TranscriptionService

Every wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; it never falls back from a failed kernel to the plain version.
"""

__version__ = "0.1.0"
