"""Device operations the profiler records a forward of the language model
in a ``decode`` call (the prefill and ``new_tokens`` - 1 single-token
steps), in Uni-MoE-2.0-Omni's cell ``omni.eval-long``."""

from benchmark.metrics._omni import decode_launches

LAYER = "decode loop (decode.decoding)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return decode_launches(facts)
