"""The whole batch's share of the card's bf16 peak (the tower, the
connector, the prefill and the decode steps, the routed experts as the
routing chose them), in Uni-MoE-2.0-Omni's cell ``omni.eval-long``."""

from benchmark.metrics._omni import batch_mfu

LAYER = "whole program"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "audio_s_per_s.large"
BETTER = "higher"


def read(facts):
    return batch_mfu(facts)
