"""Device operations (kernels, copies, fills) the profiler records inside
the ``chunk`` spans of the profiled stretch, over their steps."""

from benchmark.metrics._common import launches_per_step

LAYER = "training step (train.step, train.optimizer)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    if "chunk" not in facts:
        return None
    return launches_per_step(facts, "chunk", facts["chunk"])
