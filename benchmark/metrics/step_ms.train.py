"""Host-clock time of one training step: the span around each chunk of
``train.step.train_chunk`` (synchronised at the chunk's end, when the
losses are read), over its steps, averaged over the chunks outside the
profiled stretch."""

LAYER = "training step (train.step, train.optimizer)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(facts):
    t = facts.get("spans", {}).get("chunk")
    if not t:
        return None
    return 1e3 * sum(t) / (len(t) * facts["chunk"])
