"""The share of the profiled stretch (from the first span's start to the
last span's end) in which no device operation ran, in the cells that
report ``audio_s_per_s.large``."""

from benchmark.metrics._common import idle_pct

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return idle_pct(facts)
