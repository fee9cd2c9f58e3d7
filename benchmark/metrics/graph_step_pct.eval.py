"""The share of the decode loop's steps that replay its CUDA graph
(``decode.replay`` spans over ``decode.step`` spans) in the profiled
stretch, in the cell that reports ``audio_s_per_s``."""

from benchmark.metrics._graph import graph_step_pct

LAYER = "decode loop (decode.decoding)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "audio_s_per_s"
BETTER = "higher"


def read(facts):
    return graph_step_pct(facts)
