"""The decode steps' cross-attention over the int8 cache (K4,
``csrc/decode_attention.cu``) against its roofline, in the cells that
report ``audio_s_per_s``."""

from benchmark.metrics._eval import k4_roofline

KERNELS = ("decode_int8_cluster_kernel",)
LAYER = "kernels (ops, csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"
BETTER = "higher"


def read(facts):
    return k4_roofline(facts, KERNELS)
