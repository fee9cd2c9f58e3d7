"""The decode steps' MoE (routing, the static dispatch's batched expert
products, the shared experts): the device time of the kernels launched
inside the program's ``llm.decode.moe`` spans of the eager decode step,
against their bandwidth bound, in Uni-MoE-2.0-Omni's cell
``omni.eval-long``."""

from benchmark.metrics._omni import moe_roofline

LAYER = "audio language model (models.audio_llm)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.large"
BETTER = "higher"


def read(facts):
    return moe_roofline(facts)
