"""Kernel wrappers, each beside its plain PyTorch version.

  mel_kernel        K1  log-mel power spectrum      csrc/mel.cu
  attention         K2  encoder attention forward   csrc/attention.cu
  decode_attention  K4  int8 single-query decode    csrc/decode_attention.cu

Importing builds nothing: a kernel is compiled on its first CUDA launch
(or by ``_build.build_all()``).
"""

from .attention import attention_plain, fused_attention
from .decode_attention import (
    decode_attention_plain,
    decode_cross_attention_int8_tminor,
)
from .mel_kernel import log_mel_power, log_mel_power_plain, log_mel_spectrogram

__all__ = [
    "attention_plain",
    "decode_attention_plain",
    "decode_cross_attention_int8_tminor",
    "fused_attention",
    "log_mel_power",
    "log_mel_power_plain",
    "log_mel_spectrogram",
]
