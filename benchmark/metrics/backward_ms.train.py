"""Stream time of a training step's backward (the span ``train.backward``:
``torch.autograd.grad`` over the trainable tensors), averaged over the
steps of the profiled stretch."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "training step (train.step, train.optimizer)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    return mean_stream_ms(facts, "train.backward")
