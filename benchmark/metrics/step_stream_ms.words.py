"""Stream time of one iteration of the decode loop (the span
``decode.step``): the step's share of the card's timeline, the waits
inside it included, averaged over the steps of the profiled stretch, in
the cell that reports ``audio_s_per_s.words``."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.words"
BETTER = "lower"


def read(facts):
    return mean_stream_ms(facts, "decode.step")
