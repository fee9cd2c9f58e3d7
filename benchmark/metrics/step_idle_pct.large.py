"""The share of the profiled stretch's device idle time that falls while the
host is inside a ``decode.step`` span, on the profiler's clock, in the
cell that reports ``audio_s_per_s.large``."""

from benchmark.metrics._program import idle_inside_pct

LAYER = "decode loop (decode.decoding)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return idle_inside_pct(facts, "decode.step")
