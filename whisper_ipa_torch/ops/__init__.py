"""Kernel wrappers, each beside its plain PyTorch version.

  mel_kernel        K1  log-mel power spectrum      csrc/mel.cu
  attention         K2  encoder attention forward   csrc/attention.cu
                    K5  its backward (training)     csrc/attention_bwd.cu
  decode_attention  K4  int8 single-query decode    csrc/decode_attention.cu
                    K8  int4 single-query decode    csrc/decode_attention.cu
  kv_init           K3  fused int8 cross-KV build   csrc/kv_init.cu
  quant_matmul      K6  int8 x int8 product         csrc/quant_matmul.cu
                    K7  int4-weight product         csrc/quant_matmul.cu
  sr_quant          K9  stochastic int8 weights     csrc/sr_quant.cu
  attention         K10 head-merged attention fwd   csrc/attention.cu

``quant`` quantizes the weights on the host (no kernel); ``sr_quant``
quantizes them where they lie, a whole tree in one launch.

Importing builds nothing: a kernel is compiled on its first CUDA launch
(or by ``_build.build_all()``).
"""

from .attention import (
    attention_backward,
    attention_backward_plain,
    attention_merged_plain,
    attention_plain,
    fused_attention,
    fused_attention_merged,
)
from .blockwise_ce import blockwise_cross_entropy
from .decode_attention import (
    decode_attention_int4_plain,
    decode_attention_plain,
    decode_cross_attention_int4_tminor,
    decode_cross_attention_int8_tminor,
)
from .kv_init import fused_kv_init_int8, fused_kv_init_plain
from .mel_kernel import log_mel_power, log_mel_power_plain, log_mel_spectrogram
from .quant import quantize_params, quantized_bytes
from .quant_matmul import (
    int4_matmul,
    int4_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
)
from .sr_quant import (
    quantize_params_device,
    stochastic_quantize_int8,
    stochastic_quantize_int8_many,
    stochastic_quantize_int8_plain,
)

__all__ = [
    "attention_backward",
    "attention_backward_plain",
    "attention_merged_plain",
    "attention_plain",
    "blockwise_cross_entropy",
    "decode_attention_int4_plain",
    "decode_attention_plain",
    "decode_cross_attention_int4_tminor",
    "decode_cross_attention_int8_tminor",
    "fused_attention",
    "fused_attention_merged",
    "fused_kv_init_int8",
    "fused_kv_init_plain",
    "int4_matmul",
    "int4_matmul_plain",
    "int8_matmul",
    "int8_matmul_plain",
    "log_mel_power",
    "log_mel_power_plain",
    "log_mel_spectrogram",
    "quantize_params",
    "quantize_params_device",
    "quantized_bytes",
    "stochastic_quantize_int8",
    "stochastic_quantize_int8_many",
    "stochastic_quantize_int8_plain",
]
