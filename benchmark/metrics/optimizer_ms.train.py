"""Stream time of a training step's update (the span ``train.optimizer``: the
per-tensor clip and AdamW, one tensor at a time), averaged over the steps
of the profiled stretch."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "training step (train.step, train.optimizer)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    return mean_stream_ms(facts, "train.optimizer")
