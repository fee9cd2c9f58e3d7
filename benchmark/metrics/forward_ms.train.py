"""Stream time of a training step's forward (the span ``train.forward``: the
frozen encoder, the decoder and the loss), averaged over the steps of the
profiled stretch."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "training step (train.step, train.optimizer)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    return mean_stream_ms(facts, "train.forward")
