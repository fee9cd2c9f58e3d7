"""The whole batch's share of the card's bf16 peak, in the cells that
report ``audio_s_per_s.words``."""

from benchmark.metrics._eval import batch_mfu

LAYER = "whole program"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "audio_s_per_s.words"
BETTER = "higher"


def read(facts):
    return batch_mfu(facts)
