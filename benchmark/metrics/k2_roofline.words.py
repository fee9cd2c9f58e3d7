"""The encoder's self-attention (K2, ``csrc/attention.cu``) against its
roofline, in the cells that report ``audio_s_per_s.words``."""

from benchmark.metrics._eval import k2_roofline

KERNELS = ("attention_fwd_",)
LAYER = "kernels (ops, csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.words"
BETTER = "higher"


def read(facts):
    return k2_roofline(facts, KERNELS)
