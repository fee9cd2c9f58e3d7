"""Host time of one iteration of the decode loop (the span ``decode.step``:
masking, argmax, log-softmax, the token write, the single-token
``decode_step``, the finished check where it falls): what the host spends
enqueueing a step, averaged over the steps of the profiled stretch, in the
cell that reports ``audio_s_per_s.large``."""

from benchmark.metrics._program import mean_host_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return mean_host_ms(facts, "decode.step")
