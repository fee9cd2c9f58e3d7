"""Device operations the profiler records a decoder forward in the decode
loop, in the cells that report ``audio_s_per_s.words``."""

from benchmark.metrics._eval import decode_launches

LAYER = "decode loop (decode.decoding)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.words"
BETTER = "lower"


def read(facts):
    return decode_launches(facts)
