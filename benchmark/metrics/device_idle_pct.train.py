"""The share of the profiled stretch (from the first span's start to the
last span's end) in which no device operation ran."""

from benchmark.metrics._common import idle_pct

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    return idle_pct(facts)
