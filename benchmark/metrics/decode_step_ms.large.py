"""Host-clock time of one decoder forward in the decode loop, in the cells
that report ``audio_s_per_s.large``."""

from benchmark.metrics._eval import decode_step_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return decode_step_ms(facts)
